"""One rank of ``tests/test_torch_moe_a2a.py``'s gloo group (CPU).

  python tests/_torch_a2a_worker.py RANK WORLD WORKDIR

Reads ``WORKDIR/cases.json`` and each case's ``<name>.npz`` (the
reference's MoE layer as ``p/<key path>`` arrays and the input ``x``), runs
the case on a (1, WORLD) ``("data", "model")`` mesh, and writes
``WORKDIR/out<RANK>.npz``. Imports torch and the port only.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import moe as MOE
from repro_torch.models import moe_a2a


def _tree(data):
    tree = {}
    for key in data.files:
        if not key.startswith("p/"):
            continue
        *path, leaf = key[2:].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = data[key]
    return tree


def main(rank, world, workdir):
    cases = json.load(open(os.path.join(workdir, "cases.json")))
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    meshes = {"model": init_device_mesh("cpu", (1, world),
                                        mesh_dim_names=("data", "model")),
              "data": init_device_mesh("cpu", (world, 1),
                                       mesh_dim_names=("data", "model"))}
    calls = []
    real = moe_a2a.moe_all_to_all

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    moe_a2a.moe_all_to_all = counted
    out = {}
    for case in cases:
        cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                                  capacity_factor=case["cf"])
        data = np.load(os.path.join(workdir, case["name"] + ".npz"))
        p = convert.moe_from_reference(cfg, _tree(data), device="cpu")
        x = torch.from_numpy(data["x"])
        before = len(calls)
        if case["kind"] == "a2a":
            y, aux = moe_a2a.moe_all_to_all(cfg, p, x, meshes["model"])
        else:  # through apply_moe's hook, on the case's mesh
            MOE.A2A_MESH = meshes[case["mesh"]]
            try:
                y, aux = MOE.apply_moe(cfg, p, x)
            finally:
                MOE.A2A_MESH = None
        out[case["name"] + "/y"] = y.numpy()
        out[case["name"] + "/aux"] = aux.numpy()
        out[case["name"] + "/routed"] = np.int64(len(calls) - before)
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
