"""repro_torch — the PyTorch/CUDA port of the MicroFlow engine (``repro``).

It imports torch and numpy, never JAX and nothing of the ``repro`` package.
"""
