"""The LLM model library of the port (``repro_torch.models``) against the
JAX package's (``repro.models``), block by block and for every ``reduced()``
config: the same numpy inputs and the same parameters (drawn by
``repro.models``' own init, carried as numpy) go through both.

Tolerances (float32 on the CPU): block outputs and caches ``rtol=1e-5,
atol=1e-5``; logits ``rtol=1e-4, atol=1e-4``. The two packages contract in
different orders, so they agree to a few ulps of the values, not bit for
bit; where a tensor's largest magnitude M exceeds 1, ``atol`` is taken
times M (a float32 ulp grows with M: jamba's MoE, whose expert weights the
reference draws at ``n_experts ** -0.5``, reaches M ≈ 50)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_configs
from repro.data.pipeline import frontend_stub
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import ssm as JS
from repro_torch.models import attention as TA
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TS

BLOCK = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)

# the reference's functions jitted (the config and the mode static): one
# compile a shape instead of one per op
jgqa = jax.jit(JA.apply_gqa, static_argnums=(0, 4))
jcross = jax.jit(JA.apply_cross, static_argnums=(0, 4))
jmla = jax.jit(JA.apply_mla, static_argnums=(0, 4))
jmoe = jax.jit(JMOE.apply_moe, static_argnums=0)
jssm = jax.jit(JS.apply_ssm, static_argnums=(0, 3))
jforward = jax.jit(JM.forward, static_argnums=0)
jprefill = jax.jit(JM.prefill, static_argnums=0)
jdecode = jax.jit(JM.decode_step, static_argnums=0)


def tt(tree):
    """A JAX pytree (dicts, lists) as the same tree of CPU tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def close(port, ref, tol):
    """Every leaf of two trees (tensors / jax arrays) within ``tol``, its
    ``atol`` times the leaf's largest magnitude where that exceeds 1."""
    lp = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), port))
    lr = [np.asarray(b) for b in jax.tree.leaves(ref)]
    assert len(lp) == len(lr)
    for a, b in zip(lp, lr):
        assert a.shape == b.shape, (a.shape, b.shape)
        scale = max(1.0, float(np.nanmax(np.abs(b), initial=0.0)))
        np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


def _x(rng, *shape, s=0.3):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _pos(B, T):
    return np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)


# -- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-3b", "starcoder2-3b",
                                  "chatglm3-6b", "whisper-small"])
def test_norm_and_mlp(arch):
    """layernorm (population variance) and rmsnorm; swiglu, and gelu with
    JAX's default tanh approximation."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    d = cfg.d_model
    x = _x(rng, 2, 5, d, s=1.0) + 0.5
    pn = {"scale": jnp.asarray(rng.normal(size=d).astype("f")),
          "bias": jnp.asarray(rng.normal(size=d).astype("f"))}
    if cfg.norm != "layernorm":
        del pn["bias"]
    close(TL.apply_norm(cfg, tt(pn), torch.from_numpy(x)),
          JL.apply_norm(cfg, pn, jnp.asarray(x)), BLOCK)
    pm = JL.init_mlp(cfg, jax.random.PRNGKey(1), d, cfg.d_ff, jnp.float32)
    close(TL.apply_mlp(cfg, tt(pm), torch.from_numpy(x)),
          JL.apply_mlp(cfg, pm, jnp.asarray(x)), BLOCK)


def test_gated_rmsnorm():
    rng = np.random.default_rng(1)
    x, z, s = _x(rng, 2, 3, 64, s=1), _x(rng, 2, 3, 64, s=2), _x(rng, 64)
    close(TL.gated_rmsnorm(*map(torch.from_numpy, (x, z, s))),
          JL.gated_rmsnorm(*map(jnp.asarray, (x, z, s))), BLOCK)


# -- GQA ------------------------------------------------------------------------

GQA_CASES = {
    "standard": ("stablelm-3b", {}),
    "2d": ("chatglm3-6b", {}),
    "learned": ("whisper-small", {}),
    "window": ("starcoder2-3b", {"sliding_window": 8}),
}


@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_train_prefill_decode(case):
    """Full attention, prefill into the cache, then decode steps; with a
    window shorter than the prompt the prefill keeps the tail and decode
    wraps around the ring (``pos % W``)."""
    arch, over = GQA_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    rng = np.random.default_rng(2)
    B, T, Tp = 2, 14, 10
    pj = JA.init_gqa(cfg, jax.random.PRNGKey(2), jnp.float32)
    pt = tt(pj)
    x, pos = _x(rng, B, T, cfg.d_model), _pos(B, T)
    yj, _ = jgqa(cfg, pj, jnp.asarray(x), jnp.asarray(pos), "train")
    yt, _ = TA.apply_gqa(cfg, pt, torch.from_numpy(x), torch.from_numpy(pos),
                         "train")
    close(yt, yj, BLOCK)
    cj = JA.init_gqa_cache(cfg, B, T + 2, jnp.float32)
    ct = tt(cj)
    yj, cj = jgqa(cfg, pj, jnp.asarray(x[:, :Tp]),
                          jnp.asarray(pos[:, :Tp]), "prefill", cj)
    yt, ct = TA.apply_gqa(cfg, pt, torch.from_numpy(x[:, :Tp]),
                          torch.from_numpy(pos[:, :Tp]), "prefill", ct)
    close(yt, yj, BLOCK)
    close(ct, cj, BLOCK)
    for t in range(Tp, T):
        yj, cj = jgqa(cfg, pj, jnp.asarray(x[:, t:t + 1]),
                              jnp.asarray(pos[:, t:t + 1]), "decode", cj,
                              pos=jnp.int32(t))
        yt, ct = TA.apply_gqa(cfg, pt, torch.from_numpy(x[:, t:t + 1]),
                              torch.from_numpy(pos[:, t:t + 1]), "decode",
                              ct, pos=t)
        close(yt, yj, BLOCK)
        close(ct, cj, BLOCK)


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_past_the_cache_clamps(window):
    """A decode at ``pos >= S``: ``dynamic_update_slice`` clamps its start,
    so the reference overwrites the last slot (no window); the port mirrors
    it and does not raise."""
    cfg = dataclasses.replace(get_config("stablelm-3b").reduced(),
                              sliding_window=window)
    rng = np.random.default_rng(3)
    B, S = 2, 6
    pj = JA.init_gqa(cfg, jax.random.PRNGKey(3), jnp.float32)
    pt = tt(pj)
    cj = JA.init_gqa_cache(cfg, B, S, jnp.float32)
    cj = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype),
                      cj)
    ct = tt(cj)
    for p in (S + 3, S + 9):
        x = _x(rng, B, 1, cfg.d_model)
        yj, cj = jgqa(cfg, pj, jnp.asarray(x), jnp.full((B, 1), p),
                              "decode", cj, pos=jnp.int32(p))
        yt, ct = TA.apply_gqa(cfg, pt, torch.from_numpy(x),
                              torch.full((B, 1), p), "decode", ct, pos=p)
        close(yt, yj, BLOCK)
        close(ct, cj, BLOCK)


def test_cross_attention():
    cfg = get_config("whisper-small").reduced()
    rng = np.random.default_rng(4)
    B, T = 2, 5
    pj = JA.init_cross(cfg, jax.random.PRNGKey(4), jnp.float32)
    pt = tt(pj)
    mem = _x(rng, B, cfg.n_frames, cfg.d_model, s=1.0)
    x = _x(rng, B, T, cfg.d_model)
    yj, _ = jcross(cfg, pj, jnp.asarray(x), jnp.asarray(mem), "train")
    yt, _ = TA.apply_cross(cfg, pt, torch.from_numpy(x),
                           torch.from_numpy(mem), "train")
    close(yt, yj, BLOCK)
    cj = JA.init_cross_cache(cfg, B, jnp.float32)
    ct = tt(cj)
    yj, cj = jcross(cfg, pj, jnp.asarray(x), jnp.asarray(mem),
                            "prefill", cj)
    yt, ct = TA.apply_cross(cfg, pt, torch.from_numpy(x),
                            torch.from_numpy(mem), "prefill", ct)
    close(yt, yj, BLOCK)
    close(ct, cj, BLOCK)
    x1 = _x(rng, B, 1, cfg.d_model)
    yj, _ = jcross(cfg, pj, jnp.asarray(x1), None, "decode", cj)
    yt, _ = TA.apply_cross(cfg, pt, torch.from_numpy(x1), None, "decode", ct)
    close(yt, yj, BLOCK)


# -- MLA ------------------------------------------------------------------------

@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed", "expanded"])
def test_mla_train_prefill_decode(absorb):
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              mla_absorb=absorb)
    rng = np.random.default_rng(5)
    B, T, Tp, S = 2, 9, 6, 10
    pj = JA.init_mla(cfg, jax.random.PRNGKey(5), jnp.float32)
    pt = tt(pj)
    x, pos = _x(rng, B, T, cfg.d_model), _pos(B, T)
    yj, _ = jmla(cfg, pj, jnp.asarray(x), jnp.asarray(pos), "train")
    yt, _ = TA.apply_mla(cfg, pt, torch.from_numpy(x), torch.from_numpy(pos),
                         "train")
    close(yt, yj, BLOCK)
    cj = JA.init_mla_cache(cfg, B, S, jnp.float32)
    ct = tt(cj)
    yj, cj = jmla(cfg, pj, jnp.asarray(x[:, :Tp]),
                          jnp.asarray(pos[:, :Tp]), "prefill", cj)
    yt, ct = TA.apply_mla(cfg, pt, torch.from_numpy(x[:, :Tp]),
                          torch.from_numpy(pos[:, :Tp]), "prefill", ct)
    close(yt, yj, BLOCK)
    close(ct, cj, BLOCK)
    # the last step writes past the cache (pos 11 >= S): clamped to S - 1
    for t in list(range(Tp, T)) + [S + 1]:
        xt = _x(rng, B, 1, cfg.d_model)
        yj, cj = jmla(cfg, pj, jnp.asarray(xt), jnp.full((B, 1), t),
                              "decode", cj, pos=jnp.int32(t))
        yt, ct = TA.apply_mla(cfg, pt, torch.from_numpy(xt),
                              torch.full((B, 1), t), "decode", ct, pos=t)
        close(yt, yj, BLOCK)
        close(ct, cj, BLOCK)


# -- MoE ------------------------------------------------------------------------

MOE_CASES = {
    "kimi": ("kimi-k2-1t-a32b", {}),
    "deepseek": ("deepseek-v2-236b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "capacity_drop": ("deepseek-v2-236b", {"capacity_factor": 0.3}),
    "groups": ("kimi-k2-1t-a32b", {"moe_groups": 2}),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe(case):
    """Routing, the static capacity (overflow to the dummy row), the
    scatter-add combine, shared experts and the auxiliary loss."""
    arch, over = MOE_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    rng = np.random.default_rng(6)
    pj = JMOE.init_moe(cfg, jax.random.PRNGKey(6), jnp.float32)
    x = _x(rng, 2, 16, cfg.d_model, s=0.2)
    yj, aj = jmoe(cfg, pj, jnp.asarray(x))
    yt, at = TMOE.apply_moe(cfg, tt(pj), torch.from_numpy(x))
    close(yt, yj, BLOCK)
    close(at, aj, BLOCK)
    if case == "capacity_drop":  # some assignments really were dropped
        assert TMOE.capacity(cfg, 32) < 32 * cfg.top_k / cfg.n_experts


# -- SSM ------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 8, 13])
@pytest.mark.parametrize("fn", ["ssd_chunked", "ssd_naive"])
def test_ssd(fn, t):
    """The chunked algorithm (the tail padded with dt = 0) and the
    recurrence, each against its reference twin, from a zero and a given
    state."""
    cfg = get_config("mamba2-780m").reduced()
    rng = np.random.default_rng(t)
    B, H, P, N = 2, 4, 8, cfg.ssm_state
    x, Bm, Cm = (rng.normal(size=s).astype("f")
                 for s in ((B, t, H, P), (B, t, H, N), (B, t, H, N)))
    dt = (rng.random((B, t, H)) * 0.5 + 0.01).astype("f")
    A = -(rng.random(H) + 0.2).astype("f")
    h0 = rng.normal(size=(B, H, P, N)).astype("f")
    for init in (None, h0):
        args = (x, Bm, Cm, dt, A) + (() if init is None else (init,))
        yj, hj = getattr(JS, fn)(cfg, *map(jnp.asarray, args))
        yt, ht = getattr(TS, fn)(cfg, *map(torch.from_numpy, args))
        close([yt, ht], [yj, hj], BLOCK)


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_ssm_block_prefill_decode(arch):
    """``apply_ssm``: train mode, prefill into (conv, state), then the O(1)
    decode update, in place."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(7)
    B, T, Tp = 2, 11, 7
    pj = JS.init_ssm(cfg, jax.random.PRNGKey(7), jnp.float32)
    pj["A_log"] = jnp.asarray(rng.normal(size=pj["A_log"].shape) * 0.3, "f")
    pt = tt(pj)
    x = _x(rng, B, T, cfg.d_model)
    yj, _ = jssm(cfg, pj, jnp.asarray(x), "train")
    yt, _ = TS.apply_ssm(cfg, pt, torch.from_numpy(x), "train")
    close(yt, yj, BLOCK)
    cj = JS.init_ssm_cache(cfg, B, jnp.float32)
    ct = tt(cj)
    yj, cj = jssm(cfg, pj, jnp.asarray(x[:, :Tp]), "prefill", cj)
    yt, ct = TS.apply_ssm(cfg, pt, torch.from_numpy(x[:, :Tp]), "prefill", ct)
    close(yt, yj, BLOCK)
    close(ct, cj, BLOCK)
    ptrs = [ct["conv"].data_ptr(), ct["state"].data_ptr()]
    for t in range(Tp, T):
        yj, cj = jssm(cfg, pj, jnp.asarray(x[:, t:t + 1]), "decode",
                              cj)
        yt, ct = TS.apply_ssm(cfg, pt, torch.from_numpy(x[:, t:t + 1]),
                              "decode", ct)
        close(yt, yj, BLOCK)
        close(ct, cj, BLOCK)
    assert [ct["conv"].data_ptr(), ct["state"].data_ptr()] == ptrs


def test_ssm_prompt_shorter_than_conv_window_raises():
    """A prefill of fewer than ``ssm_conv_kernel - 1`` tokens: the
    reference keeps a short conv cache and its decode step then fails on
    the shape; the port refuses the prefill, with a message."""
    cfg = get_config("mamba2-780m").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), jnp.float32, max_seq=16)
    tokens = np.zeros((1, 2), np.int32)
    _, cj = JM.prefill(cfg, jp, {"tokens": jnp.asarray(tokens)},
                       JM.init_cache(cfg, 1, 16, jnp.float32))
    assert cj["layers"][0]["mixer"]["conv"].shape == (2, 1, 1, 544)
    with pytest.raises(ValueError):
        JM.decode_step(cfg, jp, jnp.zeros((1, 1), jnp.int32), cj,
                       jnp.int32(2))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    with pytest.raises(ValueError, match="ssm_conv_kernel - 1"):
        TM.prefill(cfg, tp, {"tokens": tokens},
                   TM.init_cache(cfg, 1, 16, torch.float32, device="cpu"))


# -- whole models -----------------------------------------------------------------

@pytest.mark.parametrize("arch", list_configs())
def test_forward_prefill_decode(arch):
    """Every ``reduced()`` config: ``forward`` (logits and the MoE loss),
    ``prefill`` (last logits and every cache tensor) and two
    ``decode_step``s, the second past the cache's end (clamped)."""
    cfg = get_config(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), jnp.float32, max_seq=32)
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    rng = np.random.default_rng(8)
    B, T = 2, 8
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T))
             .astype(np.int32), **frontend_stub(cfg, B, rng)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lj, aj = jforward(cfg, jp, jbatch)
    with torch.no_grad():
        lt, at = TM.forward(cfg, tp, batch)
    close([lt, at], [lj, aj], LOGITS)
    S = T + (cfg.n_patches if cfg.modality == "vision" else 0) + 2
    cj = JM.init_cache(cfg, B, S, jnp.float32)
    ct = convert.cache_from_reference(cfg, jax.tree.map(np.asarray, cj), B,
                                      S, device="cpu")
    lj, cj = jprefill(cfg, jp, jbatch, cj)
    with torch.no_grad():
        lt, ct = TM.prefill(cfg, tp, batch, ct)
    close(lt, lj, LOGITS)
    close(ct, cj, BLOCK)
    for p in (S - 2, S + 1):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        lj, cj = jdecode(cfg, jp, jnp.asarray(tok), cj, jnp.int32(p))
        with torch.no_grad():
            lt, ct = TM.decode_step(cfg, tp, tok, ct, p)
        close(lt, lj, LOGITS)
        close(ct, cj, BLOCK)


def test_learned_positions_past_max_seq_are_nan():
    """``jnp.take`` fills rows past ``dec_pos``'s end with NaN: a decode
    step at ``pos >= max_seq`` gives NaN logits in both packages, and no
    error."""
    cfg = get_config("whisper-small").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), jnp.float32, max_seq=8)
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    tok = np.ones((1, 1), np.int32)
    cj = JM.init_cache(cfg, 1, 12, jnp.float32)
    ct = TM.init_cache(cfg, 1, 12, torch.float32, device="cpu")
    for p, nan in ((7, False), (8, True), (11, True)):
        lj, cj = JM.decode_step(cfg, jp, jnp.asarray(tok), cj, jnp.int32(p))
        with torch.no_grad():
            lt, ct = TM.decode_step(cfg, tp, tok, ct, p)
        assert bool(np.isnan(np.asarray(lj)).all()) is nan
        assert bool(torch.isnan(lt).all()) is nan
        if not nan:
            close(lt, lj, LOGITS)


def test_params_from_reference_checks_keys_and_shapes():
    cfg = get_config("stablelm-3b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(
        cfg, jax.random.PRNGKey(0), jnp.float32, max_seq=8))
    model = convert.params_from_reference(cfg, tree, device="cpu")
    sd = model.state_dict()
    assert "layers.0.mixer.wq" in sd and "embed" in sd
    assert tuple(sd["layers.0.mixer.wq"].shape) == (2, 256, 256)
    assert not any(p.requires_grad for p in model.parameters())
    bad = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_reference(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_reference(
            cfg, {k: v for k, v in tree.items() if k != "embed"},
            device="cpu")
