"""Shared helpers of the ``test_torch_train_*`` tests: the same parameters
(drawn by the JAX package's init, carried by ``params_from_reference``) and
the same numpy batches go through both packages, and gradient trees are
compared leaf by leaf, by path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.data.pipeline import frontend_stub
from repro.models import model as JM
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.train.checkpoint import _flatten

LOSS_TOL, GRAD_TOL = 1e-4, 1e-3
B, T = 2, 8


def no_drop(cfg):
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k + 1.0)


def batch_for(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            **frontend_stub(cfg, B, rng)}


def both(cfg, seed=0, max_seq=T):
    """(jax params, port model made trainable) holding the same values."""
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32,
                        max_seq=max_seq)
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jp, TM.trainable(tp)


def assert_grads_close(got, want, tol=GRAD_TOL):
    """Every leaf by path: max |got - want| <= tol * max |want|."""
    gt, gw = dict(_flatten(got)), dict(_flatten(want))
    assert gt.keys() == gw.keys()
    worst = 0.0
    for k in gw:
        a, b = gt[k].numpy(), np.asarray(gw[k])
        assert a.shape == b.shape, k
        assert np.isfinite(a).all() and np.isfinite(b).all(), k
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= tol * scale or err == 0.0, (k, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst
