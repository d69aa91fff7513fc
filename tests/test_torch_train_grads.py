"""The port's loss and its gradients (``repro_torch.train.step``) against
``jax.value_and_grad`` of the JAX package's ``loss_fn``, on every
``reduced()`` config, from the same parameters (drawn by the reference's
init, carried by ``params_from_reference``) and the same numpy batch.

MoE configs run under a capacity no token overflows (``no_drop``), so that
a rounding difference in the router cannot drop another assignment.
Tolerances (float32 on the CPU): the loss within 1e-4; each gradient leaf
within 1e-3 of its largest |g|."""
import jax
import jax.numpy as jnp
import pytest

from _torch_train import LOSS_TOL, assert_grads_close, batch_for, both, no_drop
from repro.configs import get_config, list_configs
from repro.train import step as JS
from repro_torch.train import step as TS

_REFERENCE = {}


def _reference(arch):
    """The reference's loss and gradients of ``arch`` (computed once a
    module: the remat case is held to the same numbers, remat changes no
    value in either package), with the port's model."""
    if arch not in _REFERENCE:
        cfg = no_drop(get_config(arch).reduced())
        jp, tp = both(cfg)
        batch = batch_for(cfg, 1)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        out = jax.jit(jax.value_and_grad(
            lambda p, b: JS.loss_fn(cfg, p, b), has_aux=True))(jp, jbatch)
        _REFERENCE[arch] = cfg, tp, batch, out
    return _REFERENCE[arch]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", list_configs())
def test_loss_and_grads_match_reference(arch, remat):
    cfg, tp, batch, ((jl, jparts), jg) = _reference(arch)
    tl, tparts, tg = TS.grads_of(cfg, tp, batch, remat=remat)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL, (float(tl), float(jl))
    for k in ("ce", "aux"):
        assert abs(float(tparts[k]) - float(jparts[k])) <= LOSS_TOL, k
    assert_grads_close(tg, jg)
