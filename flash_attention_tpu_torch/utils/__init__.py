"""Utilities of the PyTorch port: the parity gates."""
