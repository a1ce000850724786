"""Hand-written CUDA kernels for Hopper (attention, its gradient and the
IVF-PQ scan), their plain PyTorch versions, and the dispatch between them."""
