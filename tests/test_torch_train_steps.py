"""Train steps of the port (``repro_torch.train.step.make_train_step``)
against the JAX package's, carried over several steps from the same
parameters and optimizer state (``params_from_reference``,
``opt_state_from_reference``), and remat against no remat.

Tolerances (float32 on the CPU): the loss within 1e-4 at every step;
parameters within 1e-5 (plus 1e-5 of the value), except where Adam's
normalized step can flip: an element whose reference gradient was nonzero
and below 1e-4 of its leaf's largest |g| at some step may differ by up to
2·lr a step. Why 1e-4 and not 1e-6: the packages' gradients agree to about
2e-6 of a leaf's largest |g| (sums in other orders), and the first step's
``g / (|g| + eps)`` moves by ``lr * eps * dg / (|g| + eps) ** 2``, past
1e-5 for |g| up to about 2e-5 of the largest (at 1e-6, 38 of stablelm's 48
elements past 1e-5 were not flagged). Those elements then differ by up to
2·lr, which moves the next steps' gradients by more than rounding: hence
the relative part (one mamba2 ``w_in`` element reaches 1.0023e-5 at step
3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (LOSS_TOL, assert_grads_close, batch_for, both,
                          no_drop)
from repro.configs import get_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.optim import adamw as JO
from repro.train import step as JS
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TO
from repro_torch.train import step as TS
from repro_torch.train.checkpoint import _flatten

PARAM_TOL, FLIP_FRAC = 1e-5, 1e-4
STEPS = 3


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-780m"])
def test_carried_steps_match_reference(arch):
    """Three steps of each package's ``make_train_step`` (the reference's
    jitted) on ``-smoke``, each from its own previous state: the loss at
    every step and the parameters after it. The elements held to the
    looser bound are counted and reported (``-s``): 14734 of 1444352 on
    stablelm, 17731 of 1080480 on mamba2, mostly the tail of small
    gradients of the embedding and the head."""
    cfg = get_config(arch + "-smoke")
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=STEPS)
    jp, tp = both(cfg, seed=0, max_seq=16)
    jopt = JO.init(jp)
    topt = convert.opt_state_from_reference(
        cfg, jax.tree.map(np.asarray, jopt), device="cpu")
    jstep = jax.jit(JS.make_train_step(cfg, JO.AdamWConfig(**opt)))
    tstep = TS.make_train_step(cfg, TO.AdamWConfig(**opt))
    jgrad = jax.jit(jax.grad(lambda p, b: JS.loss_fn(cfg, p, b)[0]))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, seed=0))
    flip = {k: np.zeros(np.shape(v), bool) for k, v in _flatten(jp)}
    bound = 0.0
    for s in range(STEPS):
        batch = data.batch(s)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for k, g in _flatten(jgrad(jp, jb)):
            g = np.abs(np.asarray(g))
            flip[k] |= (g > 0) & (g < FLIP_FRAC * g.max())
        jp, jopt, jm = jstep(jp, jopt, jb)
        tp, topt, tm = tstep(tp, topt, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL, s
        for k in ("ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        bound += 2 * float(jm["lr"])
        loose = 0
        want = dict(_flatten(jp))
        for k, t in _flatten(tp):
            w = np.asarray(want[k])
            d = np.abs(t.detach().numpy() - w) - PARAM_TOL * np.abs(w)
            assert (d[~flip[k]] <= PARAM_TOL).all(), (s, k,
                                                      d[~flip[k]].max())
            assert (d[flip[k]] <= bound + PARAM_TOL).all(), (s, k)
            loose += int(flip[k].sum())
        assert int(topt["step"]) == int(jopt["step"]) == s + 1
    n = sum(f.size for f in flip.values())
    print(f"{arch}: {loose} of {n} elements under the 2·lr bound")
    assert loose < 0.02 * n  # 1.0% (stablelm), 1.6% (mamba2)


def test_port_state_carried_back_steps_like_the_reference():
    """A state the port trained (params and AdamW state after two port
    steps; MoE under ``no_drop``) carried back to the JAX package
    (``convert.to_numpy``): the next step from it gives the same loss, lr
    and grad norm in both packages, and the same first moments."""
    cfg = no_drop(get_config("jamba-v0.1-52b").reduced())
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=6)
    _, tp = both(cfg, seed=5)
    topt = TO.init(tp)
    tstep = TS.make_train_step(cfg, TO.AdamWConfig(**opt))
    for s in range(2):
        tstep(tp, topt, batch_for(cfg, s))
    jp, jopt = convert.to_numpy(tp), convert.to_numpy(topt)
    assert jopt["step"].dtype == np.int32 and jopt["step"].shape == ()
    batch = batch_for(cfg, 2)
    jp, jopt, jm = jax.jit(JS.make_train_step(cfg, JO.AdamWConfig(**opt)))(
        jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, tm = tstep(tp, topt, batch)
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(jopt["step"]) == int(topt["step"]) == 3
    want = dict(_flatten(jopt["mu"]))
    for k, t in _flatten(topt["mu"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ["stablelm-3b", "jamba-v0.1-52b",
                                  "whisper-small"])
def test_remat_equals_plain_and_recomputes(arch, monkeypatch):
    """``remat=True`` gives the loss and every gradient of ``remat=False``
    within 1e-6 (of the leaf's largest |g|), and the layers run twice:
    once forward, once recomputed in the backward pass."""
    cfg = get_config(arch).reduced()
    _, tp = both(cfg, seed=1)
    batch = batch_for(cfg, 2)
    calls = []
    orig = TT.apply_layer
    monkeypatch.setattr(TT, "apply_layer",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    l0, _, g0 = TS.grads_of(cfg, tp, batch)
    plain = len(calls)
    calls.clear()
    l1, _, g1 = TS.grads_of(cfg, tp, batch, remat=True)
    decoder = cfg.n_periods * len(cfg.pattern())
    assert plain >= decoder and len(calls) == plain + decoder
    assert abs(float(l1) - float(l0)) <= 1e-6
    assert_grads_close(g1, {k: v.numpy() for k, v in _flatten(g0)}, tol=1e-6)


def test_train_step_returns_its_inputs_written_in_place():
    """Donation becomes writing in place: the step returns the model and
    the state it was given, their tensors at the same addresses, and the
    five metrics as 0-d tensors."""
    cfg = get_config("stablelm-3b-smoke")
    _, tp = both(cfg, seed=3)
    opt = TO.init(tp)
    ptrs = [t.data_ptr() for _, t in _flatten([tp, opt])]
    before = [t.detach().clone() for _, t in _flatten(tp)]
    step = TS.make_train_step(cfg, TO.AdamWConfig(lr=1e-3, warmup_steps=1))
    tp2, opt2, m = step(tp, opt, batch_for(cfg, 4))
    assert tp2 is tp and opt2 is opt
    assert [t.data_ptr() for _, t in _flatten([tp, opt])] == ptrs
    assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "lr"]
    assert all(v.dim() == 0 and not v.requires_grad for v in m.values())
    assert any(not torch.equal(a, b) for a, (_, b) in
               zip(before, _flatten(tp)))
    ev = TS.make_eval_step(cfg)(tp, batch_for(cfg, 4))
    assert sorted(ev) == ["aux", "ce", "loss"] and not ev["loss"].requires_grad
