"""Tensor ops of the loss graph; ``warp`` and ``cost_volume`` hold the CUDA
kernels' wrappers beside their plain PyTorch versions."""
