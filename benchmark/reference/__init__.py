"""The benchmark's plain reference (NumPy and plain PyTorch), independent
of the program under test."""
