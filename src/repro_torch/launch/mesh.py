"""Production meshes (the port of ``repro.launch.mesh``) over
``torch.distributed.device_mesh``.

Single pod: (data=16, model=16) = 256 GPUs.
Multi-pod:  (pod=2, data=16, model=16) = 512 GPUs.

The shapes are the reference's, so that the sharding specs of the two
packages compare one for one. On H100 nodes of eight GPUs a ``model`` axis
of 16 spans two NVLink domains: its collectives cross the inter-node
network, not NVLink alone.

A :class:`~torch.distributed.device_mesh.DeviceMesh` needs a process group
whose world size is the mesh's size: the real one under ``torchrun``, or
the fake one of :func:`fake_world` for a dry run, which allocates nothing
and reaches no card. Every mesh is made by a function, so importing this
module starts no group.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile

import torch
import torch.distributed as dist

# H100 SXM data sheet (per GPU): the roofline's constants
PEAK_BF16_FLOPS = 989e12      # dense bfloat16 tensor-core FLOP/s
HBM_BW = 3.35e12              # HBM3 bytes/s
NVLINK_BW = 900e9             # NVLink bytes/s, total per GPU

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _fake_pg_store():
    """The fake process group's store. The module is internal to torch:
    a torch without it fails here, by name, and not later."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "this torch has no torch.testing._internal.distributed.fake_pg; "
            "a dry run needs its fake process group") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0), destroyed on exit. Collectives on it return at once and move no
    data: a mesh over it is a placeholder, as the reference's host devices
    are. Raises if a group is already active."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks is active; "
            "a fake world needs none")
    dist.init_process_group("fake", store=_fake_pg_store(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the active process group,
    whose world size must be the mesh's size."""
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh {shape} needs a process group of "
                           f"{math.prod(shape)} ranks; none is active")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"mesh {shape} needs {math.prod(shape)} ranks; "
                           f"the active group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type)


def make_local_mesh(device: str = "cuda"):
    """1-device mesh with the same axis names (smoke tests). Starts a
    one-rank group when none is active (gloo on the CPU, NCCL on the
    card, over a ``FileStore`` in a temporary directory); raises when a
    group of another size is."""
    device_type = torch.device(device).type
    if not dist.is_initialized():
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                            "store")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.FileStore(path, 1), rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, of a mapping, or of any object
    with ``axis_names`` and ``devices.shape`` (the reference's mesh and its
    tests' stand-ins)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def data_axes(mesh) -> tuple:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))
