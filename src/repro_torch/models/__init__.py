"""Dense GQA transformer for serving, in PyTorch."""
