"""repro_torch.core — graph IR, quantization, compile-time folding and the
compiled engine, in PyTorch."""
from .engine import (CompiledModel, ExecutionPlan, bucket_floor,  # noqa: F401
                     bucket_for, dispatched_bucket_rows)
