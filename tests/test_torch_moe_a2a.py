"""The port's expert-parallel all-to-all MoE (``repro_torch.models.moe_a2a``)
on four gloo processes (CPU), against the JAX package on the same weights:

* at a generous capacity, against the reference's ``apply_moe`` (the bar of
  ``tests/test_moe_a2a.py``: 0 for kimi-k2, 5e-5 for deepseek-v2; where
  the two libraries' summation orders differ, within 1e-5 × max|y|);
* at a capacity that drops tokens, against the reference's own
  ``moe_all_to_all``, run in a JAX process with 4 host devices on a (1, 4)
  mesh;
* the ``A2A_MESH`` hook of ``apply_moe``, routing and declining.

One set of processes runs every case (``tests/_torch_a2a_worker.py``).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import moe as JMOE

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-5  # × max|y|, where the summation order forbids 0

CASES = [  # name, arch, capacity factor, x shape, kind, mesh
    ("kimi", "kimi-k2-1t-a32b", 16.0, (2, 16), "a2a", "model"),
    ("deepseek", "deepseek-v2-236b", 16.0, (1, 8), "a2a", "model"),
    ("tight", "kimi-k2-1t-a32b", 0.5, (2, 16), "a2a", "model"),
    ("hook_route", "kimi-k2-1t-a32b", 16.0, (2, 16), "hook", "model"),
    ("hook_odd_tokens", "kimi-k2-1t-a32b", 16.0, (1, 6), "hook", "model"),
    ("hook_no_model_axis", "kimi-k2-1t-a32b", 16.0, (2, 16), "hook", "data"),
]

_JAX_A2A = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models.moe_a2a import moe_all_to_all

work, name, arch, cf = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
cfg = dataclasses.replace(get_config(arch).reduced(), capacity_factor=cf)
data = np.load(os.path.join(work, name + ".npz"))
tree = {}
for k in data.files:
    if k.startswith("p/"):
        *path, leaf = k[2:].split("/")
        node = tree
        for s in path:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(data[k])
mesh = make_mesh((1, 4), ("data", "model"))
with mesh:
    y, aux = jax.jit(lambda p, x: moe_all_to_all(cfg, p, x, mesh))(
        tree, jnp.asarray(data["x"]))
np.savez(os.path.join(work, name + "_jax_a2a.npz"), y=np.asarray(y),
         aux=np.asarray(aux))
"""


def _cfg(arch, cf):
    return dataclasses.replace(get_config(arch).reduced(), capacity_factor=cf)


def _flat(tree, prefix="p"):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case through the four ranks, the JAX reference beside it."""
    work = tmp_path_factory.mktemp("a2a")
    rng = np.random.default_rng(0)
    ref = {}
    for i, (name, arch, cf, xs, _, _) in enumerate(CASES):
        cfg = _cfg(arch, cf)
        p = JMOE.init_moe(cfg, jax.random.PRNGKey(i), jnp.float32)
        x = (rng.normal(size=xs + (cfg.d_model,)) * 0.2).astype(np.float32)
        np.savez(work / f"{name}.npz", x=x, **_flat(p))
        y, aux = jax.jit(lambda p, x, cfg=cfg: JMOE.apply_moe(cfg, p, x))(
            p, jnp.asarray(x))
        ref[name] = {"p": jax.tree.map(np.asarray, p), "x": x,
                     "y": np.asarray(y), "aux": np.asarray(aux)}
    (work / "cases.json").write_text(json.dumps(
        [{"name": n, "arch": a, "cf": cf, "kind": k, "mesh": m}
         for n, a, cf, _, k, m in CASES]))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_a2a_worker.py"),
         str(r), str(WORLD), str(work)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    _, arch, cf, _, _, _ = CASES[2]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX_A2A, str(work), "tight", arch, str(cf)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True))
    errs = []
    for pr in procs:
        try:
            _, err = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if pr.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)
    ranks = [np.load(work / f"out{r}.npz") for r in range(WORLD)]
    jax_a2a = np.load(work / "tight_jax_a2a.npz")
    return ref, ranks, jax_a2a


def _close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), err
    return err


@pytest.mark.parametrize("name", ["kimi", "deepseek"])
def test_a2a_equals_reference_apply_moe(run, name):
    """Generous capacity: no token dropped, so the two-hop schedule gives
    ``apply_moe``'s y on every rank."""
    ref, ranks, _ = run
    want = ref[name]["y"]
    for out in ranks:
        got = out[f"{name}/y"]
        assert got.shape == want.shape and np.isfinite(got).all()
        err = _close(got, want)
        if name == "deepseek":
            assert err < 5e-5, err


def test_every_rank_returns_the_same(run):
    _, ranks, _ = run
    for name, *_ in CASES:
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"{name}/y"],
                                          ranks[0][f"{name}/y"])
            np.testing.assert_array_equal(out[f"{name}/aux"],
                                          ranks[0][f"{name}/aux"])


def _stage1_drops(cfg, p, x):
    """Assignments past each (source rank, destination rank) slab's
    capacity C1, from the router alone."""
    n = x.shape[0] * x.shape[1]
    n_loc, E_loc, k = n // WORLD, cfg.n_experts // WORLD, cfg.top_k
    C1 = max(int(n_loc * k / WORLD * cfg.capacity_factor), k)
    logits = x.reshape(n, -1).astype(np.float64) @ p["router"]
    top = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    dest = (top // E_loc).reshape(WORLD, n_loc * k)
    counts = np.stack([np.bincount(d, minlength=WORLD) for d in dest])
    return int(np.maximum(counts - C1, 0).sum())


def test_a2a_drops_tokens_like_reference_a2a(run):
    """A capacity that drops tokens: the port's schedule drops the same
    ones as the reference's ``moe_all_to_all``."""
    ref, ranks, jax_a2a = run
    r = ref["tight"]
    _, arch, cf, *_ = CASES[2]
    assert _stage1_drops(_cfg(arch, cf), r["p"], r["x"]) > 0
    assert float(np.abs(jax_a2a["y"] - r["y"]).max()) > \
        TOL * float(np.abs(r["y"]).max())  # dropping changed y
    for out in ranks:
        _close(out["tight/y"], jax_a2a["y"])
        np.testing.assert_allclose(out["tight/aux"], jax_a2a["aux"],
                                   rtol=1e-6)


@pytest.mark.parametrize("name,routed", [
    ("hook_route", 1), ("hook_odd_tokens", 0), ("hook_no_model_axis", 0)])
def test_a2a_mesh_hook(run, name, routed):
    """``A2A_MESH`` routes through the all-to-all only when the model axis
    has S > 1 ranks, S divides the experts and the tokens; otherwise
    ``apply_moe`` runs as without it. Either way y is the reference's."""
    ref, ranks, _ = run
    for out in ranks:
        assert int(out[f"{name}/routed"]) == routed
        _close(out[f"{name}/y"], ref[name]["y"])
