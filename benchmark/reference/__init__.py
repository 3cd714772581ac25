"""Plain PyTorch reference of the registration model (see dit.py)."""
