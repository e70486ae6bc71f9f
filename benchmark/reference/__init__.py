"""The plain reference: PyTorch and NumPy only, nothing of the system
under test, and nothing the system made."""
