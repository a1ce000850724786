"""PyTorch/CUDA port of the serving paths and of training (see README,
PyTorch/CUDA port)."""
