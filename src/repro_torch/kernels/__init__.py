"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``csrc/``),
their plain PyTorch versions (``ref``) and the wrappers around them."""


def launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel: each wrapper adds
    one to its count where it launches its kernel, and nowhere else (a CPU
    tensor's plain version does not count, nor does a CUDA-graph replay)."""
    from . import ops, paged_matmul, qdwconv, qmatmul
    return {"qmatmul": qmatmul.launches,
            "qmatmul_conv": qmatmul.conv_launches,
            "qdwconv": qdwconv.launches,
            "paged_qmatmul": paged_matmul.launches,
            "fmatmul": qmatmul.fmatmul_launches,
            "probe": ops.probe_launches}
