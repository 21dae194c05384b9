"""The plain reference that decides a run's ``correct``: PyTorch and NumPy
only. It imports nothing of the program and takes nothing the program made
but the outputs it judges."""
