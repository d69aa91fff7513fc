"""The LLM path in bfloat16 on the CPU, against the JAX package: the same
bfloat16 parameters (drawn by ``repro.models``' own init, carried as numpy)
and the same prompts go through both, at the shapes of ``chip_smoke.py``'s
``llm`` phase (4 prompts of 16 tokens, 16 teacher-forced decode steps), with
the MoE capacity raised so that no assignment is dropped (``no_drop``, as
check 1 there).

Tolerances (bfloat16):

* port against reference, the logits of ``forward`` and of prefill plus
  teacher-forced decode: ``max |diff| <= 2e-2 * max |logit|``, about five
  bfloat16 ulps at the largest logit (the two packages round their
  intermediates at different points);
* each package's own prefill plus decode against its ``forward``:
  ``<= 5e-2 * max |logit|``, the bfloat16 bound of check 1 on the card.

Where an MoE routes the output of a path whose bfloat16 rounding differs
between ``forward`` and the cache path (MLA absorbed at decode and expanded
in ``forward``; SSD chunked in prefill and recurrent at decode), a token can
pick another expert, and its logits move far: the reference itself exceeds
the check-1 bound there. :data:`ROUTED_AFTER_INEXACT` names those configs,
and the test holds both packages to that, and to the bound once the MoE is
taken out. Run as a script, the file prints every ratio."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_configs
from repro.data.pipeline import frontend_stub
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

B, TP, NEW = 4, 16, 16
PARITY = 2e-2   # port vs reference, x max |logit|
CHECK1 = 5e-2   # prefill + decode vs forward, x max |logit|

# config -> the overrides that take its MoE layers out
ROUTED_AFTER_INEXACT = {
    "deepseek-v2-236b": {"n_experts": 0, "top_k": 0, "n_shared_experts": 0},
    "jamba-v0.1-52b": {"moe_every": 0},
}

jforward = jax.jit(JM.forward, static_argnums=0)
jprefill = jax.jit(JM.prefill, static_argnums=0)
jdecode = jax.jit(JM.decode_step, static_argnums=0)


def no_drop(cfg):
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k + 1.0)


def _jax_logits(cfg, jp, tokens, extra, S, n_prefix):
    """(forward's logits at positions TP-1.., prefill + decode's): both
    (NEW + 1, B, V) float32."""
    c1 = no_drop(cfg)
    ex = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in extra.items()}
    full = np.concatenate([np.asarray(jforward(c1, jp, {
        "tokens": jnp.asarray(tokens[b:b + 1]),
        **{k: v[b:b + 1] for k, v in ex.items()}})[0][:, TP - 1:],
        np.float32) for b in range(B)]).transpose(1, 0, 2)
    lg, cache = jprefill(c1, jp, {"tokens": jnp.asarray(tokens[:, :TP]),
                                  **ex}, JM.init_cache(cfg, B, S,
                                                       jnp.bfloat16))
    steps = [np.asarray(lg[:, -1], np.float32)]
    for i in range(NEW):
        lg, cache = jdecode(c1, jp, jnp.asarray(tokens[:, TP + i:TP + i + 1]),
                            cache, jnp.int32(TP + n_prefix + i))
        steps.append(np.asarray(lg[:, -1], np.float32))
    return full, np.stack(steps)


@torch.no_grad()
def _port_logits(cfg, tp, tokens, extra, S, n_prefix):
    c1 = no_drop(cfg)
    tok = torch.from_numpy(tokens)
    ex = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in extra.items()}
    full = torch.cat([TM.forward(c1, tp, {
        "tokens": tok[b:b + 1], **{k: v[b:b + 1] for k, v in ex.items()}})[0]
        [:, TP - 1:].float() for b in range(B)]).transpose(0, 1)
    cache = TM.init_cache(cfg, B, S, torch.bfloat16, device="cpu")
    lg, _ = TM.prefill(c1, tp, {"tokens": tok[:, :TP], **ex}, cache)
    steps = [lg[:, -1].float()]
    for i in range(NEW):
        lg, _ = TM.decode_step(c1, tp, tok[:, TP + i:TP + i + 1], cache,
                               TP + n_prefix + i)
        steps.append(lg[:, -1].float())
    return full.numpy(), torch.stack(steps).numpy()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def bf16_ratios(arch, **over) -> dict:
    """The reduced config ``arch`` (with ``over``) in bfloat16: each
    package's prefill + decode against its forward, and the port against
    the reference, x max |logit|."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    n_prefix = cfg.n_patches if cfg.modality == "vision" else 0
    S = 64 + n_prefix
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16, max_seq=S)
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, TP + NEW)).astype(np.int32)
    extra = frontend_stub(cfg, B, rng)
    jf, js = _jax_logits(cfg, jp, tokens, extra, S, n_prefix)
    tf, ts = _port_logits(cfg, tp, tokens, extra, S, n_prefix)
    for a in (jf, js, tf, ts):
        assert np.isfinite(a).all()
    return {"reference": _rel(js, jf), "port": _rel(ts, tf),
            "forward_parity": _rel(tf, jf), "decode_parity": _rel(ts, js)}


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_bf16_ssm_conv_rounds_as_reference(arch):
    """The SSM block's causal conv in bfloat16, bit for bit against the
    reference's code run op by op: the sums in float32, the conv's output
    rounded to bfloat16 and the bias added in bfloat16 before the float32
    silu. (Under ``jax.jit`` XLA folds the bias add into the float32 silu
    and rounds once less.)"""
    cfg = get_config(arch).reduced()
    conv_dim = JS.dims(cfg)[-1]
    rng = np.random.default_rng(9)
    xbc = jnp.asarray(rng.normal(size=(2, 13, conv_dim)), jnp.bfloat16)
    p = {"conv_w": jnp.asarray(rng.normal(size=(cfg.ssm_conv_kernel,
                                                conv_dim)) * 0.5,
                               jnp.bfloat16),
         "conv_b": jnp.asarray(rng.normal(size=conv_dim) * 0.3,
                               jnp.bfloat16)}
    want = np.asarray(JS._conv_full(cfg, xbc, p), np.float32)
    got = TS._conv_full(cfg, convert._tensor(xbc),
                        {k: convert._tensor(v) for k, v in p.items()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize(
    "arch", [a for a in list_configs() if a not in ROUTED_AFTER_INEXACT])
def test_bf16_matches_reference(arch):
    r = bf16_ratios(arch)
    assert r["forward_parity"] <= PARITY, r
    assert r["decode_parity"] <= PARITY, r
    assert r["reference"] <= CHECK1, r
    assert r["port"] <= CHECK1, r


@pytest.mark.parametrize("arch", sorted(ROUTED_AFTER_INEXACT))
def test_bf16_routing_after_inexact_path(arch):
    """With its MoE, the config's cache path leaves the check-1 bound in
    the reference as in the port; without it, both keep to it."""
    r = bf16_ratios(arch)
    assert r["reference"] > CHECK1 and r["port"] > CHECK1, r
    dense = bf16_ratios(arch, **ROUTED_AFTER_INEXACT[arch])
    assert dense["reference"] <= CHECK1 and dense["port"] <= CHECK1, dense


if __name__ == "__main__":
    for arch in list_configs():
        print(arch, bf16_ratios(arch), flush=True)
        if arch in ROUTED_AFTER_INEXACT:
            print(arch, "without MoE",
                  bf16_ratios(arch, **ROUTED_AFTER_INEXACT[arch]), flush=True)
