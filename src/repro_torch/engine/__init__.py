"""Paged serving engine of the PyTorch port."""
