"""The port's models: PixelLink STD through the microcode seam."""
