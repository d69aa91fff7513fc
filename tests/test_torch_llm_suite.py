"""The JAX package's model and serving tests that need no training,
optimizer or mesh (``tests/test_models.py``, ``tests/test_serving.py``,
``tests/test_archs.py``, ``test_substrate.py::test_serve_greedy_deterministic``
and ``::test_data_deterministic_and_learnable``), copied onto the port:
each runs with ``device="cpu"`` and keeps the JAX test's own tolerance.
The reference's ``test_decode_cache_donation_no_copy`` becomes: the cache
tensors' ``data_ptr()``s are unchanged after decode."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import get_config, list_configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM, frontend_stub
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import tree_map
from repro_torch.serve.engine import ServeSession
from repro_torch.serve.quantized import (dequantize_params, param_bytes,
                                         quantize_params)

settings.register_profile("ci", max_examples=10, deadline=None)
settings.load_profile("ci")

CPU = "cpu"
ARCHS = list_configs()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _init_block(init, cfg, seed):
    """A block's float32 parameters drawn from its ``Init`` tree."""
    return M.draw(init(cfg, torch.float32), seed, CPU)


# -- SSD ----------------------------------------------------------------------

@given(seed=st.integers(0, 2**31 - 1), t=st.integers(1, 40))
def test_ssd_chunked_equals_naive(seed, t):
    """State-space duality: the chunked algorithm == the recurrence."""
    cfg = get_config("mamba2-780m").reduced()
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 4, 8, cfg.ssm_state
    x = _t(rng.normal(size=(B, t, H, P)).astype("f"))
    Bm = _t(rng.normal(size=(B, t, H, N)).astype("f"))
    Cm = _t(rng.normal(size=(B, t, H, N)).astype("f"))
    dt = _t((rng.random((B, t, H)) * 0.5 + 0.01).astype("f"))
    Av = -_t((rng.random(H) + 0.2).astype("f"))
    y1, h1 = SSM.ssd_chunked(cfg, x, Bm, Cm, dt, Av)
    y2, h2 = SSM.ssd_naive(cfg, x, Bm, Cm, dt, Av)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-4)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-4)


def test_ssd_carries_state_across_calls():
    cfg = get_config("mamba2-780m").reduced()
    rng = np.random.default_rng(0)
    B, t, H, P, N = 1, 16, 2, 4, cfg.ssm_state
    mk = lambda *s: _t(rng.normal(size=s).astype("f"))  # noqa: E731
    x, Bm, Cm = mk(B, t, H, P), mk(B, t, H, N), mk(B, t, H, N)
    dt = _t((rng.random((B, t, H)) * 0.3 + 0.01).astype("f"))
    Av = -torch.ones(H)
    y_all, h_all = SSM.ssd_chunked(cfg, x, Bm, Cm, dt, Av)
    y1, h1 = SSM.ssd_chunked(cfg, x[:, :8], Bm[:, :8], Cm[:, :8], dt[:, :8],
                             Av)
    y2, h2 = SSM.ssd_chunked(cfg, x[:, 8:], Bm[:, 8:], Cm[:, 8:], dt[:, 8:],
                             Av, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_all.numpy(), atol=2e-4)
    np.testing.assert_allclose(h2.numpy(), h_all.numpy(), atol=2e-4)


# -- RoPE -----------------------------------------------------------------------

@given(seed=st.integers(0, 2**31 - 1), shift=st.integers(0, 64))
def test_rope_relative_property(seed, shift):
    """<rope(q,i), rope(k,j)> depends only on i - j."""
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(1, 1, 1, 32)).astype("f"))
    k = _t(rng.normal(size=(1, 1, 1, 32)).astype("f"))

    def dot(i, j):
        qi = A.apply_rope(q, torch.tensor([[i]]), "standard", 10000.0)
        kj = A.apply_rope(k, torch.tensor([[j]]), "standard", 10000.0)
        return float((qi * kj).sum())
    assert abs(dot(5, 3) - dot(5 + shift, 3 + shift)) < 1e-3


def test_rope_2d_rotates_half():
    x = torch.ones((1, 1, 1, 8))
    y = A.apply_rope(x, torch.tensor([[7]]), "2d", 10000.0)
    # the second half of the head dim passes through untouched
    np.testing.assert_array_equal(y[..., 4:].numpy(), x[..., 4:].numpy())
    assert not np.allclose(y[..., :4].numpy(), x[..., :4].numpy())


# -- GQA cache ------------------------------------------------------------------

def _gqa_cache(cfg, B, S):
    return {k: torch.zeros(sd[0]) for k, sd in A.gqa_cache_shapes(cfg, B, S)
            .items()}


@pytest.mark.parametrize("arch", ["starcoder2-3b", "chatglm3-6b"])
def test_gqa_prefill_decode_matches_full(arch):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    B, T, d = 2, 12, cfg.d_model
    p = _init_block(A.init_gqa, cfg, 0)
    x = _t((rng.normal(size=(B, T, d)) * 0.3).astype("f"))
    pos = torch.arange(T)[None].expand(B, T)
    y_full, _ = A.apply_gqa(cfg, p, x, pos, "train")
    cache = _gqa_cache(cfg, B, T + 2)
    y_pre, cache = A.apply_gqa(cfg, p, x[:, :T - 2], pos[:, :T - 2],
                               "prefill", cache)
    np.testing.assert_allclose(y_pre.numpy(), y_full[:, :T - 2].numpy(),
                               atol=1e-5)
    for t in range(T - 2, T):
        y_t, cache = A.apply_gqa(cfg, p, x[:, t:t + 1], pos[:, t:t + 1],
                                 "decode", cache, pos=t)
        np.testing.assert_allclose(y_t.numpy(), y_full[:, t:t + 1].numpy(),
                                   atol=1e-5)


def test_sliding_window_decode_ring_buffer():
    """With window W, the decode cache stays W slots and the step output
    matches attention over the last W tokens."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              sliding_window=8)
    rng = np.random.default_rng(4)
    B, T, d = 1, 20, cfg.d_model
    p = _init_block(A.init_gqa, cfg, 4)
    x = _t((rng.normal(size=(B, T, d)) * 0.3).astype("f"))
    pos = torch.arange(T)[None].expand(B, T)
    cache = _gqa_cache(cfg, B, 1024)
    assert cache["k"].shape[1] == 8  # capacity == window, not seq_len
    full_cfg = dataclasses.replace(cfg, sliding_window=0)
    for t in range(T):
        y_t, cache = A.apply_gqa(cfg, p, x[:, t:t + 1], pos[:, t:t + 1],
                                 "decode", cache, pos=t)
    lo = T - 8
    y_ref, _ = A.apply_gqa(full_cfg, p, x[:, lo:], pos[:, lo:], "train")
    np.testing.assert_allclose(y_t.numpy(), y_ref[:, -1:].numpy(), atol=1e-5)


# -- MLA ------------------------------------------------------------------------

def _mla_cache(cfg, B, S):
    return {k: torch.zeros(sd[0]) for k, sd in A.mla_cache_shapes(cfg, B, S)
            .items()}


def test_mla_absorbed_decode_equals_naive():
    """Decode-time weight absorption is an exact algebraic rewriting:
    absorbed and naive-expansion decode must agree."""
    cfg = get_config("deepseek-v2-236b").reduced()
    rng = np.random.default_rng(3)
    B, T, d = 2, 8, cfg.d_model
    p = _init_block(A.init_mla, cfg, 3)
    x = _t((rng.normal(size=(B, T, d)) * 0.3).astype("f"))
    pos = torch.arange(T)[None].expand(B, T)
    outs = {}
    for absorb in (False, True):
        c = dataclasses.replace(cfg, mla_absorb=absorb)
        cache = _mla_cache(c, B, T)
        _, cache = A.apply_mla(c, p, x[:, :T - 2], pos[:, :T - 2],
                               "prefill", cache)
        ys = []
        for t in range(T - 2, T):
            y_t, cache = A.apply_mla(c, p, x[:, t:t + 1], pos[:, t:t + 1],
                                     "decode", cache, pos=t)
            ys.append(y_t)
        outs[absorb] = torch.cat(ys, 1).numpy()
    np.testing.assert_allclose(outs[True], outs[False], atol=2e-5)


def test_mla_cache_is_compressed():
    cfg = get_config("deepseek-v2-236b").reduced()
    cache = _mla_cache(cfg, 2, 64)
    full_kv = 2 * 64 * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    mla_kv = cache["ckv"].numel() + cache["krope"].numel()
    assert mla_kv < full_kv / 2  # the paper's KV-cache reduction


# -- MoE ------------------------------------------------------------------------

@given(seed=st.integers(0, 2**31 - 1))
def test_moe_output_finite_and_aux_near_one(seed):
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                              capacity_factor=4.0)
    rng = np.random.default_rng(seed)
    p = _init_block(MOE.init_moe, cfg, seed)
    x = _t((rng.normal(size=(2, 16, cfg.d_model)) * 0.2).astype("f"))
    y, aux = MOE.apply_moe(cfg, p, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    # aux ≈ 1 for near-uniform routing, >= 1 generally (Cauchy-Schwarz)
    assert 0.9 <= float(aux) < float(cfg.n_experts)


def test_moe_respects_capacity_drops():
    """With capacity_factor→0 every token is dropped: output = shared-only."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              capacity_factor=1e-9)
    rng = np.random.default_rng(0)
    p = _init_block(MOE.init_moe, cfg, 0)
    n = 32
    x = _t(rng.normal(size=(1, n, cfg.d_model)).astype("f"))
    y, _ = MOE.apply_moe(cfg, p, x)
    shared = L.apply_mlp(cfg, p["shared"], x.reshape(n, -1)).reshape(x.shape)
    # capacity floor is top_k slots; most tokens dropped -> y ≈ shared for
    # at least half the tokens
    close = np.isclose(y.numpy(), shared.numpy(), atol=1e-5).all(-1).mean()
    assert close > 0.5, close


def test_moe_flops_scale_with_active_not_total():
    """param_count(active) ≈ top_k/E of routed params."""
    c = get_config("kimi-k2-1t-a32b")
    total, active = c.param_count(), c.param_count(active_only=True)
    routed_ratio = (c.top_k + c.n_shared_experts) / \
        (c.n_experts + c.n_shared_experts)
    assert active / total < 2.5 * routed_ratio + 0.35


# -- quantized serving ------------------------------------------------------------

def test_quantized_serving_close_to_float():
    cfg = get_config("stablelm-3b").reduced()
    rng = np.random.default_rng(2)
    params = M.init_params(cfg, 2, torch.float32, max_seq=32, device=CPU)
    qp = quantize_params(params.tree())
    deq = dequantize_params(qp)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8))
             .astype(np.int32)}
    with torch.no_grad():
        lf, _ = M.forward(cfg, params, batch)
        lq, _ = M.forward(cfg, deq, batch)
    # int8 weight-only keeps logits close; ranking of the top token is a
    # softer, more meaningful check
    top_f = lf.argmax(-1).numpy()
    top_q = lq.argmax(-1).numpy()
    assert (top_f == top_q).mean() > 0.8
    assert param_bytes(qp) < 0.45 * param_bytes(params.tree())


# -- serving (tests/test_serving.py) ----------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-26b",
                                  "jamba-v0.1-52b"])
def test_serve_session_modalities(arch):
    """Batched generate() works for enc-dec (cross-attn cache), VLM (patch
    prefix positions), and hybrid (ssm + kv caches together)."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    params = M.init_params(cfg, 0, torch.float32, max_seq=96, device=CPU)
    sess = ServeSession(cfg, params, max_seq=96, device=CPU)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    extra = frontend_stub(cfg, 2, rng)
    out = sess.generate(prompts, 5, extra_inputs=extra or None)
    assert out.shape == (2, 5)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()


def test_serve_quantized_matches_structure():
    cfg = get_config("internlm2-20b").reduced()
    rng = np.random.default_rng(1)
    params = M.init_params(cfg, 1, torch.float32, max_seq=64, device=CPU)
    qs = ServeSession(cfg, params, max_seq=64, quantized=True, device=CPU)
    fs = ServeSession(cfg, params, max_seq=64, quantized=False, device=CPU)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    a = qs.generate(prompts.copy(), 6)
    b = fs.generate(prompts.copy(), 6)
    # int8 weight-only on a random (untrained) model: most tokens agree
    assert (a == b).mean() >= 0.5


def test_model_level_sliding_window_long_decode():
    """Full-forward logits over the last W tokens match windowed decode
    after >W steps (by correlation: positions differ)."""
    W = 8
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              sliding_window=W)
    full_cfg = get_config("starcoder2-3b").reduced()
    rng = np.random.default_rng(2)
    params = M.init_params(cfg, 2, torch.float32, max_seq=64, device=CPU)
    T = 20
    toks = rng.integers(0, cfg.vocab_size, (1, T)).astype(np.int32)

    cache = M.init_cache(cfg, 1, 1024, torch.float32, device=CPU)
    # windowed cache capacity must be W per layer, regardless of S
    k_leaves = [t for t in _leaves(cache) if t.ndim == 5]
    assert k_leaves and all(t.shape[2] == W for t in k_leaves)
    with torch.no_grad():
        for t in range(T):
            logits, cache = M.decode_step(cfg, params, toks[:, t:t + 1],
                                          cache, t)
        ref_logits, _ = M.forward(full_cfg, params,
                                  {"tokens": toks[:, T - W:]})
    a = logits[0, -1].double().numpy()
    b = ref_logits[0, -1].double().numpy()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.5, corr


def test_decode_cache_updated_in_place():
    """The port of the reference's cache donation: decode writes the cache
    in place and returns the same tree; no tensor is reallocated."""
    cfg = get_config("chatglm3-6b").reduced()
    params = M.init_params(cfg, 0, torch.float32, max_seq=32, device=CPU)
    cache = M.init_cache(cfg, 2, 16, torch.float32, device=CPU)
    ptrs = [t.data_ptr() for t in _leaves(cache)]
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with torch.no_grad():
        for pos in range(3):
            logits, cache2 = M.decode_step(cfg, params, tok, cache, pos)
            assert cache2 is cache
    assert [t.data_ptr() for t in _leaves(cache)] == ptrs
    assert all(float(t[:, :, 3:].abs().max()) == 0.0
               for t in _leaves(cache))          # slots past pos 2 untouched
    assert all(float(t[:, :, :3].abs().max()) > 0.0 for t in _leaves(cache))


# -- architectures (tests/test_archs.py) --------------------------------------------

B, T = 2, 16


def _batch(cfg, rng):
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T))
            .astype(np.int32), **frontend_stub(cfg, B, rng)}


def test_all_ten_archs_registered():
    assert len(ARCHS) == 10
    families = {get_config(a).family for a in ARCHS}
    assert families == {"dense", "moe", "hybrid", "vlm", "audio", "ssm"}


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_assigned_config(arch):
    """The full config must carry the exact assigned numbers."""
    expected = {
        "starcoder2-3b": (30, 3072, 24, 2, 12288, 49152),
        "kimi-k2-1t-a32b": (61, 7168, 64, 8, 2048, 163840),
        "stablelm-3b": (32, 2560, 32, 32, 6912, 50304),
        "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024),
        "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
        "internvl2-26b": (48, 6144, 48, 8, 16384, 92553),
        "whisper-small": (12, 768, 12, 12, 3072, 51865),
        "deepseek-v2-236b": (60, 5120, 128, 128, 1536, 102400),
        "mamba2-780m": (48, 1536, 0, 0, 0, 50280),
        "internlm2-20b": (48, 6144, 48, 8, 16384, 92544),
    }[arch]
    c = get_config(arch)
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab_size) == expected
    assert c.source  # every config cites its source


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_within_limits(arch):
    r = get_config(arch).reduced()
    assert r.n_layers <= 8 and r.d_model <= 512
    assert r.n_experts <= 4
    assert r.family == get_config(arch).family


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward(arch):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(sum(map(ord, arch)))
    params = M.init_params(cfg, 0, torch.float32, max_seq=T, device=CPU)
    with torch.no_grad():
        logits, aux = M.forward(cfg, params, _batch(cfg, rng))
    assert logits.shape == (B, T, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), arch
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_param_count_sanity(arch):
    """Full-config parameter counts in the publicly reported ballpark."""
    c = get_config(arch)
    n = c.param_count()
    n_active = c.param_count(active_only=True)
    expected_total = {"kimi-k2-1t-a32b": 1.0e12, "deepseek-v2-236b": 236e9,
                      "jamba-v0.1-52b": 52e9}[arch]
    assert 0.5 * expected_total < n < 1.8 * expected_total, \
        (arch, n, expected_total)
    assert n_active < n


# -- substrate (tests/test_substrate.py) --------------------------------------------

def test_data_deterministic_and_learnable():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=4, seed=3)
    a = SyntheticLM(cfg).batch(7)
    b = SyntheticLM(cfg).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    c = SyntheticLM(cfg).batch(8)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # learnable: labels mostly follow the fixed permutation
    perm = SyntheticLM(cfg).perm
    frac = (perm[a["tokens"]] == a["labels"]).mean()
    assert frac > 0.8


def test_serve_greedy_deterministic():
    cfg = get_config("starcoder2-3b").reduced()
    params = M.init_params(cfg, 0, torch.float32, max_seq=64, device=CPU)
    sess = ServeSession(cfg, params, max_seq=64, device=CPU)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    a = sess.generate(prompts.copy(), 6)
    sess2 = ServeSession(cfg, params, max_seq=64, device=CPU)
    b = sess2.generate(prompts.copy(), 6)
    np.testing.assert_array_equal(a, b)
