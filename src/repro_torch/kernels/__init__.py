"""Hand-written CUDA kernels for Hopper (attention and the IVF-PQ scan),
their plain PyTorch versions, and the dispatch between them."""
