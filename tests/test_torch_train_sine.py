"""The sine predictor's trainer (``examples/torch_train_sine.py``) against
the JAX package's (``benchmarks/bench_accuracy.py`` ``train_sine_weights``),
and the example's Table 5 metrics on the CPU."""
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import torch_train_sine as TS  # noqa: E402


def _jax_init(seed=0):
    """The reference's initial weights: its ``PRNGKey(seed)`` draws, as
    numpy."""
    import jax
    import jax.numpy as jnp
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    w1 = jax.random.normal(ks[0], (1, 16))
    knots = jnp.linspace(0.0, 2 * np.pi, 16)[None]
    return [(np.asarray(w1), np.asarray((-w1 * knots)[0])),
            (np.asarray(jax.random.normal(ks[1], (16, 16)) * 0.3),
             np.zeros(16, "f")),
            (np.asarray(jax.random.normal(ks[2], (16, 1)) * 0.3),
             np.zeros(1, "f"))]


def _jax_train(init, steps, seed=0):
    """``bench_accuracy.train_sine_weights``' loop, started from ``init``
    (the reference draws its own start; the loop is copied here so that
    both trainers start from one point)."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw

    params = {k: {"w": jnp.asarray(w), "b": jnp.asarray(b)}
              for k, (w, b) in zip(TS.LAYERS, init)}

    def fwd(p, x):
        h = jnp.maximum(x @ p["l0"]["w"] + p["l0"]["b"], 0)
        h = jnp.maximum(h @ p["l1"]["w"] + p["l1"]["b"], 0)
        return h @ p["l2"]["w"] + p["l2"]["b"]

    opt_cfg = adamw.AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=50,
                                total_steps=steps, grad_clip=10.0)
    state = adamw.init(params)
    rng = np.random.default_rng(seed)

    @jax.jit
    def step(p, s, x, y):
        grads = jax.grad(lambda pp: jnp.mean((fwd(pp, x) - y) ** 2))(p)
        return adamw.update(opt_cfg, grads, s, p)

    for _ in range(steps):
        x = rng.uniform(0, 2 * np.pi, (128, 1)).astype("f")
        params, state, _ = step(params, state, x, np.sin(x))
    return [(np.asarray(params[k]["w"]), np.asarray(params[k]["b"]))
            for k in TS.LAYERS]


@pytest.mark.parametrize("steps", [1, 50])
def test_trainer_matches_the_reference_loop(steps):
    """From the reference's initial weights and the same x stream, the
    port's AdamW steps land within 1e-5 × max |w| of the reference's,
    leaf for leaf."""
    init = _jax_init()
    want = _jax_train(init, steps)
    got = TS.train_sine_weights(steps, init=init, device="cpu")
    scale = max(float(np.abs(a).max()) for pair in want for a in pair)
    for (gw, gb), (ww, wb), (iw, _) in zip(got, want, init):
        assert gw.shape == ww.shape == iw.shape and gw.dtype == np.float32
        np.testing.assert_allclose(gw, ww, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-5 * scale)
    moved = max(float(np.abs(w - i).max()) for (w, _), (i, _) in
                zip(want, init))
    assert moved > 1e-4  # the steps did move the weights


def test_init_is_seeded_and_places_the_knots():
    a, b = TS.init_sine_weights(0), TS.init_sine_weights(0)
    for (wa, ba), (wb, bb) in zip(a, b):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ba, bb)
    assert not np.array_equal(TS.init_sine_weights(1)[0][0], a[0][0])
    w1, b1 = a[0]
    knots = np.linspace(0, 2 * np.pi, 16, dtype="f")
    np.testing.assert_allclose(-b1 / w1[0], knots, rtol=1e-5, atol=1e-6)


def test_sine_metrics_on_the_cpu():
    """The example's full protocol (4000 steps, 1000 test samples): every
    engine's MSE near the noise floor of U(-0.1, 0.1) (0.0033), the int8
    interpreter and the compiled engine bit-identical."""
    res = TS.sine_metrics(device="cpu")
    for k in ("float", "int8_interp", "int8_compiled"):
        assert res[k]["mse"] <= 0.006, res
        assert res[k]["rmse"] == pytest.approx(res[k]["mse"] ** 0.5)
    assert res["engines_equal"] is True
