"""LLM serving of the port (``repro_torch.serve.engine`` / ``.quantized``,
``repro_torch.data.pipeline``, ``python -m repro_torch.launch.serve``)
against the JAX package's, on the CPU.

Tolerances: logits ``rtol=1e-4, atol=1e-4`` (float32); greedy tokens are
equal at every step whose top-2 logit margin in the reference exceeds 10×
that tolerance (1e-3); int8 weights are bit-exact."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import pipeline as JP
from repro.models import model as JM
from repro.serve import engine as JE
from repro.serve import quantized as JQ
from repro_torch.data import pipeline as TP
from repro_torch.launch import serve as TLS
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE
from repro_torch.serve import quantized as TQ

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGITS = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
jprefill = jax.jit(JM.prefill, static_argnums=0)
jdecode = jax.jit(JM.decode_step, static_argnums=0)


def _pair(arch, seed=0, max_seq=64):
    cfg = get_config(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32,
                        max_seq=max_seq)
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return cfg, jp, tp


def _margin(logits):
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _teacher_forced(cfg, jsess, tsess, prompts, extra, tokens):
    """Both sessions' prefill and decode steps fed the reference's greedy
    ``tokens``: each step's logits held within tolerance, and the port's
    argmax equal to the reference's token where its margin exceeds
    ``MARGIN``. Returns the reference's margins, (B, max_new)."""
    B, Tp = prompts.shape
    batch = {"tokens": prompts, **(extra or {})}
    jparams = (JQ.dequantize_params(jsess.params) if jsess.quantized
               else jsess.params)
    jcache = JM.init_cache(cfg, B, jsess.max_seq, jnp.float32)
    lj, jcache = jprefill(cfg, jparams,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jcache)
    tcache = tsess.init_cache(B)
    ptrs = [t.data_ptr() for t in jax.tree.leaves(tcache)]
    with torch.no_grad():
        lt, tcache = tsess.run("prefill", batch, tcache)
    n_prefix = cfg.n_patches if cfg.modality == "vision" else 0
    margins = []
    for i in range(tokens.shape[1]):
        lj, lt = np.asarray(lj[:, -1]), lt[:, -1].numpy()
        np.testing.assert_allclose(lt, lj, **LOGITS)
        m = _margin(lj)
        margins.append(m)
        sure = m > MARGIN
        np.testing.assert_array_equal(lt.argmax(-1)[sure], tokens[sure, i])
        tok = tokens[:, i:i + 1]
        lj, jcache = jdecode(cfg, jparams, jnp.asarray(tok), jcache,
                             jnp.int32(Tp + n_prefix + i))
        with torch.no_grad():
            lt, tcache = tsess.run("decode_step", torch.from_numpy(tok),
                                   tcache, Tp + n_prefix + i)
    assert [t.data_ptr() for t in jax.tree.leaves(tcache)] == ptrs
    return np.stack(margins, 1)


def _equal_until_unsure(got, want, margins):
    """Greedy rows equal up to the first step whose margin is at most
    ``MARGIN``: from there the two may rightly part."""
    for row in range(want.shape[0]):
        unsure = np.flatnonzero(margins[row] <= MARGIN)
        stop = unsure[0] if unsure.size else want.shape[1]
        np.testing.assert_array_equal(got[row, :stop], want[row, :stop])


@pytest.mark.parametrize("arch,quantized", [
    ("starcoder2-3b", False), ("whisper-small", False),
    ("internvl2-26b", False), ("jamba-v0.1-52b", False),
    ("stablelm-3b", True)])
def test_generate_teacher_forced(arch, quantized):
    """``generate`` against the JAX ``ServeSession``: enc-dec (the cross
    cache), VLM (decode positions after the patch prefix), hybrid (SSM and
    KV caches), and int8 weight-only."""
    cfg, jp, tp = _pair(arch, max_seq=48)
    rng = np.random.default_rng(1)
    B, Tp, new = 2, 6, 5
    prompts = rng.integers(0, cfg.vocab_size, (B, Tp)).astype(np.int32)
    extra = TP.frontend_stub(cfg, B, np.random.default_rng(2)) or None
    jsess = JE.ServeSession(cfg, jp, max_seq=48, quantized=quantized)
    tsess = TE.ServeSession(cfg, tp, max_seq=48, quantized=quantized,
                            device="cpu")
    want = jsess.generate(prompts.copy(), new, extra_inputs=extra)
    got = tsess.generate(prompts.copy(), new, extra_inputs=extra)
    assert got.shape == (B, new) and got.dtype == np.int32
    margins = _teacher_forced(cfg, jsess, tsess, prompts, extra, want)
    _equal_until_unsure(got, want, margins)


@pytest.mark.parametrize("arch", ["stablelm-3b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b", "deepseek-v2-236b",
                                  "whisper-small"])
def test_quantize_params_bit_exact(arch):
    """The stacked leaves are quantized as one tensor: one scale per output
    channel shared by every period (and expert). ``q`` and ``scale`` equal
    the reference's bit for bit, small leaves stay float, and the
    dequantized trees and byte counts are equal."""
    cfg, jp, tp = _pair(arch, seed=3, max_seq=16)
    jq = JQ.quantize_params(jp)
    tq = TQ.quantize_params(tp.tree())
    is_q = lambda x: isinstance(x, JQ.QuantizedTensor)  # noqa: E731
    jl = jax.tree.leaves(jq, is_leaf=is_q)
    tl = jax.tree.leaves(tq, is_leaf=lambda x: isinstance(
        x, TQ.QuantizedTensor))
    assert len(jl) == len(tl)
    n_q = 0
    for a, b in zip(tl, jl):
        assert isinstance(a, TQ.QuantizedTensor) == is_q(b)
        if is_q(b):
            n_q += 1
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
            np.testing.assert_array_equal(a.scale.numpy(),
                                          np.asarray(b.scale))
            assert a.scale.shape == (a.q.shape[-1],)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert n_q > 0
    if arch == "stablelm-3b":
        wq = tq["layers"][0]["mixer"]["wq"]
        assert wq.q.shape == (2, 256, 256) and wq.scale.shape == (256,)
    assert TQ.param_bytes(tq) == JQ.param_bytes(jq)
    assert TQ.param_bytes(tp.tree()) == JQ.param_bytes(jp)
    for a, b in zip(jax.tree.leaves(TQ.dequantize_params(tq)),
                    jax.tree.leaves(JQ.dequantize_params(jq))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantized_session_keeps_int8_only():
    """The quantized session holds int8 weights and a module skeleton with
    no storage; a step runs through ``functional_call``."""
    cfg, _, tp = _pair("stablelm-3b", max_seq=32)
    sess = TE.ServeSession(cfg, tp, max_seq=32, quantized=True, device="cpu")
    assert all(p.is_meta for p in sess.model.parameters())
    assert TQ.param_bytes(sess.params) < 0.45 * TQ.param_bytes(tp.tree())
    assert isinstance(sess.params["layers.0.mixer.wq"], TQ.QuantizedTensor)
    out = sess.generate(np.zeros((1, 4), np.int32), 3)
    assert out.shape == (1, 3)


def test_data_pipeline_matches_reference():
    cfg = JP.DataConfig(vocab_size=97, seq_len=12, global_batch=3, seed=5)
    for step in (0, 7):
        a = JP.SyntheticLM(cfg).batch(step)
        b = TP.SyntheticLM(TP.DataConfig(**vars(cfg))).batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    for arch in ("internvl2-26b", "whisper-small", "stablelm-3b"):
        c = get_config(arch).reduced()
        a = JP.frontend_stub(c, 2, np.random.default_rng(4))
        b = TP.frontend_stub(c, 2, np.random.default_rng(4))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_cut_depth_takes_whole_periods():
    jamba = get_config("jamba-v0.1-52b")
    assert TLS.cut_depth(jamba, 8).n_periods == 1
    assert TLS.cut_depth(get_config("stablelm-3b"), 2).n_layers == 2
    for bad in (0, 4, 12):
        with pytest.raises(ValueError, match="period"):
            TLS.cut_depth(jamba, bad)


_CLI = """
import runpy, sys
sys.argv = ["repro_torch.launch.serve"] + {args!r}
runpy.run_module("repro_torch.launch.serve", run_name="__main__")
print("FORBIDDEN=" + ",".join(sorted(n for n in sys.modules
      if n.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


@pytest.mark.parametrize("extra", [[], ["--quantized"]],
                         ids=["float", "quantized"])
def test_cli_on_the_cpu(extra):
    """``python -m repro_torch.launch.serve --arch stablelm-3b-smoke --device
    cpu [--quantized]`` in a subprocess: the reference's lines, the
    parameter count and the resident weight bytes, and nothing of JAX or
    the JAX package loaded."""
    args = ["--arch", "stablelm-3b-smoke", "--device", "cpu"] + extra
    out = subprocess.run([sys.executable, "-c", _CLI.format(args=args)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "FORBIDDEN=", lines[-1]
    head = [ln for ln in lines if ln.startswith("[serve] arch=")]
    assert head and f"quantized={bool(extra)}" in head[0]
    assert "-> 64 tokens" in head[0]
    assert any(ln.startswith("[serve] sample:") for ln in lines)
    info = next(ln for ln in lines if "param_count=" in ln)
    fields = dict(kv.split("=") for kv in info.split()[1:])
    assert fields["device"] == "cpu" and fields["layers"] == "2"
    assert int(fields["param_count"]) == \
        get_config("stablelm-3b-smoke").param_count()
    ratio = int(fields["weight_bytes"]) / int(fields["float_weight_bytes"])
    assert (ratio < 0.45) if extra else ratio == 1.0


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLS.main(["--arch", "stablelm-3b-smoke"])
