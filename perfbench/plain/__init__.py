"""The benchmark's plain reference: PixelLink's FCN forward in the
configuration's BFP datapath, connected components and boxes, in plain
PyTorch, NumPy and SciPy.  Nothing here imports the program under test.
"""
