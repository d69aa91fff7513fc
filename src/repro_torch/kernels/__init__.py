"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``csrc/``),
their plain PyTorch versions (``ref``) and the wrappers around them."""
