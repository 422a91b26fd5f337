"""Plain NumPy / PyTorch references that decide ``correct``.  Nothing here
imports the program under test, the harness, or JAX."""
