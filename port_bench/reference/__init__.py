"""Plain PyTorch and NumPy reference of one GenFV round (paper Sec. III-V):
the GroupNorm ResNet-18, local SGD, eq. 4, the AIGC generators (`generators/`), SUBP1
selection and the SUBP2-4 numpy solvers. It imports nothing of the program
under test."""
