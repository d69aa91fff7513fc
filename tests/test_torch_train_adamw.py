"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX package's
(``repro.optim.adamw``): the schedule at every step of a run and past its
end, one update on the same numpy gradients, state and parameters (within
1e-6 relative), the reference's weight-decay rule held by leaf name, and
the substrate's optimizer tests (``tests/test_substrate.py``) copied onto
the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JO
from repro_torch.optim import adamw as TO
from repro_torch.train.checkpoint import _flatten

CFGS = [TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100),
        TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20,
                       min_lr_frac=0.0),
        TO.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=7)]


def _j(cfg):
    return JO.AdamWConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("cfg", CFGS, ids=["warm10", "warm2_min0", "warm0"])
def test_schedule_equals_reference_at_every_step(cfg):
    """Steps 0 .. total + 2 against the reference's schedule jitted on a
    scalar step, as its train step runs it: warm-up and the flat end bit
    for bit; on the cosine, where XLA's float32 cosine and a float64 one
    rounded to float32 differ by an ulp at about one value in a hundred,
    within 4 ulp of the result."""
    jfn = jax.jit(lambda s: JO.schedule(_j(cfg), s))
    steps = np.arange(cfg.total_steps + 3, dtype=np.int32)
    want = np.stack([np.asarray(jfn(jnp.int32(s))) for s in steps])
    got = np.stack([TO.schedule(cfg, torch.tensor(int(s), dtype=torch.int32))
                    .numpy() for s in steps])
    assert got.dtype == np.float32
    flat = (steps < cfg.warmup_steps) | (steps >= cfg.total_steps)
    np.testing.assert_array_equal(got[flat], want[flat])
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    assert (got != want).mean() <= 0.02


def _tree(rng):
    """A params-like tree: stacked matrices, stacked norm scales
    ``(n_periods, d)``, an unstacked norm and a vector."""
    return {"embed": rng.normal(size=(16, 8)).astype("f"),
            "final_norm": {"scale": (1 + 0.1 * rng.normal(size=8))
                           .astype("f")},
            "layers": [{"norm1": {"scale": (1 + 0.1 * rng.normal(
                size=(2, 8))).astype("f")},
                "mlp": {"w_in": rng.normal(size=(2, 8, 12)).astype("f")}}],
            "bias": rng.normal(size=12).astype("f")}


def _like(tree, rng, s):
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * s)
                        .astype("f"), tree)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("step0", [0, 5])
def test_update_matches_reference(clip, step0):
    """One update from the same state: params, ``mu``, ``nu``, the step,
    ``lr`` and ``grad_norm`` within 1e-6 relative; the port writes its
    params and state in place."""
    rng = np.random.default_rng(step0)
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10,
                         grad_clip=clip)
    p = _tree(rng)
    g = _like(p, rng, 0.5)
    st = {"mu": _like(p, rng, 0.1), "nu": jax.tree.map(
        np.abs, _like(p, rng, 0.1)), "step": np.int32(step0)}
    jp, jst, jm = jax.jit(lambda g, s, p: JO.update(_j(cfg), g, s, p))(
        g, st, p)
    tt = lambda tree: jax.tree.map(lambda a: torch.tensor(np.array(a)),  # noqa
                                   tree)
    tp, tst = tt(p), tt(st)
    ptrs = [t.data_ptr() for _, t in _flatten([tp, tst])]
    tp2, tst2, tm = TO.update(cfg, tt(g), tst, tp)
    assert tp2 is tp and tst2 is tst
    assert [t.data_ptr() for _, t in _flatten([tp, tst])] == ptrs
    assert tst["step"].dtype == torch.int32 and int(tst["step"]) == step0 + 1
    for (k, a), (_, b) in zip(_flatten({"p": tp, "mu": tst["mu"],
                                        "nu": tst["nu"]}),
                              _flatten({"p": jp, "mu": jst["mu"],
                                        "nu": jst["nu"]})):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0, err_msg=k)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, err_msg=k)


def test_weight_decay_goes_to_every_leaf_with_two_dims():
    """The reference's rule, ``p.ndim >= 2``, mirrored (ROADMAP Queue 3):
    with zero gradients only decay moves a leaf, so the stacked norm scale
    ``layers/0/norm1/scale`` (``(n_periods, d)``) is decayed like the
    matrices, while the unstacked ``final_norm/scale`` and the vector are
    not — in both packages."""
    rng = np.random.default_rng(3)
    cfg = TO.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10,
                         weight_decay=0.1)
    p = _tree(rng)
    zeros = jax.tree.map(np.zeros_like, p)
    st = {"mu": zeros, "nu": zeros, "step": np.int32(0)}
    jp, _, _ = JO.update(_j(cfg), zeros, st, p)
    tp = jax.tree.map(lambda a: torch.tensor(np.array(a)), p)
    TO.update(cfg, jax.tree.map(lambda a: torch.tensor(np.array(a)), zeros),
              jax.tree.map(lambda a: torch.tensor(np.array(a)), st), tp)
    lr = float(TO.schedule(cfg, 1))
    decayed = {}
    for (k, a), (_, b), (_, p0) in zip(_flatten(tp), _flatten(jp),
                                       _flatten(p)):
        moved = not np.array_equal(a.numpy(), p0)
        assert moved == (not np.array_equal(np.asarray(b), p0)), k
        decayed[k] = moved
        if moved:
            np.testing.assert_allclose(a.numpy(), p0 * (1 - lr * 0.1),
                                       rtol=1e-6, err_msg=k)
    assert decayed == {"bias": False, "embed": True,
                       "final_norm/scale": False,
                       "layers/0/mlp/w_in": True,
                       "layers/0/norm1/scale": True}


def test_update_in_bfloat16_keeps_float32_moments():
    """bfloat16 params: the update runs in float32 and is cast back, the
    moments stay float32 (as ``init`` makes them), as in the reference."""
    rng = np.random.default_rng(4)
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    p32 = {"w": rng.normal(size=(4, 8)).astype("f")}
    g32 = {"w": rng.normal(size=(4, 8)).astype("f")}
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p32)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g32)
    jp2, jst, _ = JO.update(_j(cfg), jg, JO.init(jp), jp)
    tp = {"w": torch.tensor(p32["w"]).bfloat16()}
    tst = TO.init(tp)
    TO.update(cfg, {"w": torch.tensor(g32["w"]).bfloat16()}, tst, tp)
    assert tp["w"].dtype == torch.bfloat16
    assert tst["mu"]["w"].dtype == tst["nu"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["w"].float().numpy(), np.asarray(jp2["w"].astype(jnp.float32)))
    np.testing.assert_allclose(tst["nu"]["w"].numpy(),
                               np.asarray(jst["nu"]["w"]), rtol=1e-6)


# -- copied from tests/test_substrate.py ---------------------------------------

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = TO.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                         total_steps=200, grad_clip=100.0)
    state = TO.init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = TO.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_grad_clip():
    params = {"w": torch.zeros(3)}
    cfg = TO.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                         weight_decay=0.0)
    state = TO.init(params)
    _, _, m = TO.update(cfg, {"w": torch.full((3,), 1e6)}, state, params)
    assert float(m["grad_norm"]) > 1e6  # reported pre-clip


def test_schedule_warmup_and_decay():
    cfg = TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    assert float(TO.schedule(cfg, torch.tensor(5, dtype=torch.int32))) \
        == pytest.approx(0.5)
    assert float(TO.schedule(cfg, torch.tensor(100, dtype=torch.int32))) \
        == pytest.approx(0.1)
