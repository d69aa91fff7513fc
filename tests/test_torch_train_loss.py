"""The port's loss on its other paths against the JAX package's: the
chunked cross-entropy (``loss_fn(..., chunked_ce=)``, the substrate's
``test_chunked_ce_exact`` copied onto the port and held to the reference),
the SSM's gradients where its decay does and does not overflow, and the
refusal of frozen leaves. Tolerances as ``test_torch_train_grads.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (LOSS_TOL, T, assert_grads_close, batch_for, both,
                          no_drop)
from repro.configs import get_config
from repro.train import step as JS
from repro_torch.models import model as TM
from repro_torch.train import step as TS
from repro_torch.train.checkpoint import _flatten


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v2-236b",
                                  "internvl2-26b"])
def test_chunked_ce_matches_reference(arch):
    """``chunked_ce`` (online softmax over vocabulary chunks, a chunk that
    does not divide V included) against the reference's: loss and grads."""
    cfg = no_drop(get_config(arch).reduced())
    jp, tp = both(cfg, seed=2)
    batch = batch_for(cfg, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for chunk in (128, 100):
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: JS.loss_fn(cfg, p, b, chunked_ce=chunk),
            has_aux=True))(jp, jbatch)
        tl, _, tg = TS.grads_of(cfg, tp, batch, chunked_ce=chunk)
        assert abs(float(tl) - float(jl)) <= LOSS_TOL
        assert_grads_close(tg, jg)


def test_ssm_grads_finite_at_init_nan_where_the_decay_overflows():
    """``ssd_chunked`` takes ``exp(L_t - L_s)`` before the causal mask, in
    both packages. With the reference's init (``A_log = 0``) and at
    ``A_log = 3`` nothing overflows: every gradient is finite and within
    tolerance. At ``A_log = 4`` the masked upper triangle overflows to inf
    and its zero cotangent times inf is NaN: the loss stays finite, and
    both packages give NaN gradients at the same elements (a reference
    quirk the port mirrors, ROADMAP Queue 3)."""
    cfg = get_config("mamba2-780m").reduced()
    batch = batch_for(cfg, 5)
    for a_log, nan in ((0.0, False), (3.0, False), (4.0, True)):
        jp, tp = both(cfg, seed=4)
        for i, layer in enumerate(jp["layers"]):
            layer["mixer"]["A_log"] = jnp.full_like(layer["mixer"]["A_log"],
                                                    a_log)
            with torch.no_grad():
                tp.layers[i].mixer.A_log.fill_(a_log)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: JS.loss_fn(cfg, p, batch), has_aux=True))(jp)
        tl, _, tg = TS.grads_of(cfg, tp, batch)
        assert abs(float(tl) - float(jl)) <= LOSS_TOL
        if not nan:
            assert_grads_close(tg, jg)
            continue
        gt, gw = dict(_flatten(tg)), dict(_flatten(jg))
        n_nan = 0
        for k in gw:
            mask = np.isnan(np.asarray(gw[k]))
            np.testing.assert_array_equal(torch.isnan(gt[k]).numpy(), mask,
                                          err_msg=k)
            n_nan += int(mask.sum())
        assert n_nan > 0


def test_frozen_leaves_are_refused():
    """A model is drawn frozen, for serving; the step differentiates only
    leaves made trainable, and says so."""
    cfg = get_config("stablelm-3b").reduced()
    model = TM.init_params(cfg, 0, torch.float32, max_seq=T, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="trainable"):
        TS.grads_of(cfg, model, batch_for(cfg, 0))
    assert TM.trainable(model) is model
    assert all(p.requires_grad for p in model.parameters())
    loss, _, grads = TS.grads_of(cfg, model, batch_for(cfg, 0))
    assert torch.isfinite(loss) and not loss.requires_grad
    assert all(p.grad is None for p in model.parameters())  # no accumulation
    TM.trainable(model, False)
    assert not any(p.requires_grad for p in model.parameters())


def test_chunked_ce_exact():
    """Copied from ``tests/test_substrate.py``: the chunked cross-entropy
    equals the full-logits one, loss and gradients, divisible chunks or
    not."""
    cfg = get_config("stablelm-3b").reduced()
    rng = np.random.default_rng(0)
    model = TM.trainable(TM.init_params(cfg, 0, torch.float32, max_seq=16,
                                        device="cpu"))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32)}
    l0, _, g0 = TS.grads_of(cfg, model, batch)
    for chunk in (128, 100):
        l1, _, g1 = TS.grads_of(cfg, model, batch, chunked_ce=chunk)
        assert abs(float(l0) - float(l1)) < 1e-5
        err = max(float((a - b).abs().max())
                  for (_, a), (_, b) in zip(_flatten(g0), _flatten(g1)))
        assert err < 1e-5
