"""The port's models through the microcode seam: PixelLink STD
(``fcn``) and the LM stack (``lm``)."""
