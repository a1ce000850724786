"""The model families in PyTorch: serving, and training for GQA."""
