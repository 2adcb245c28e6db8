"""Collective operations of the PyTorch port."""
