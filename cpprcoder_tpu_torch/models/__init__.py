"""Model tables of the port (context model in plain PyTorch)."""
