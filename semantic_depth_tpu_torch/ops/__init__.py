"""Tensor ops of the PyTorch port; ``knn_grid``, ``mad`` and ``radius`` hold
the hand-written CUDA kernels beside their plain PyTorch versions."""
