"""Checkpoints of the port (``repro_torch.train.checkpoint``) against the JAX
package's (``repro.train.checkpoint``): a file either package writes is
restored by the other bit for bit, both write the same bytes for the same
tree, the port reads and writes with no msgpack installed, and the
substrate's checkpoint tests (``tests/test_substrate.py``) copied onto the
port."""
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
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import model as JM
from repro.optim import adamw as JO
from repro.train import checkpoint as JC
from repro.train import step as JS
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from repro_torch.train import checkpoint as TC
from repro_torch.train import step as TS
from repro_torch.train.checkpoint import _flatten

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _state(arch, dtype=jnp.float32, steps=1):
    """A JAX (params, opt) state after ``steps`` reference train steps, and
    the port's template of the same tree (a fresh port init)."""
    cfg = get_config(arch).reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), dtype, max_seq=8)
    jopt = JO.init(jp)
    step = jax.jit(JS.make_train_step(cfg, JO.AdamWConfig(lr=1e-3)))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2, seed=1))
    for s in range(steps):
        jp, jopt, _ = step(jp, jopt, {k: jnp.asarray(v)
                                      for k, v in data.batch(s).items()})
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = TM.init_params(cfg, 7, tdtype, max_seq=8, device="cpu")
    return cfg, {"params": jp, "opt": jopt}, {"params": tp.tree(),
                                              "opt": TO.init(tp)}


def _port_bits(t):
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy()
    return t.detach().numpy()


def _assert_bit_equal(port, ref):
    p, r = dict(_flatten(port)), dict(_flatten(ref))
    assert p.keys() == r.keys()
    for k in r:
        a, b = _port_bits(p[k]), np.asarray(r[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8),
                                      err_msg=k)


@pytest.mark.parametrize("arch,dtype", [
    ("stablelm-3b", jnp.float32), ("stablelm-3b", jnp.bfloat16),
    ("jamba-v0.1-52b", jnp.bfloat16)],
    ids=["stablelm-float32", "stablelm-bfloat16", "jamba-bfloat16"])
def test_reference_file_restores_bit_equal_and_bytes_match(arch, dtype,
                                                           tmp_path):
    """The reference saves params and AdamW state after a step; the port
    restores them into its own template bit for bit (the int32 step, the
    float32 moments and the params in their dtype; jamba's float32 router
    among bfloat16 leaves), and writing that tree back gives the
    reference's file byte for byte."""
    cfg, jstate, template = _state(arch, dtype)
    path = str(tmp_path / "step_1.msgpack")
    JC.save(jstate, path)
    got = TC.restore(template, path)
    _assert_bit_equal(got, jstate)
    assert got["opt"]["step"].dtype == torch.int32
    assert got["opt"]["step"].shape == ()
    again = str(tmp_path / "again" / "step_1.msgpack")
    TC.save(got, again)
    assert pathlib.Path(again).read_bytes() == pathlib.Path(path).read_bytes()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_port_file_restores_bit_equal_in_reference(dtype, tmp_path):
    """The port saves its state after a port step; the reference restores
    it into its own template bit for bit."""
    cfg, jstate, _ = _state("mamba2-780m", dtype, steps=0)
    tp = convert.params_from_reference(
        cfg, jax.tree.map(np.asarray, jstate["params"]), device="cpu")
    TM.trainable(tp)
    topt = TO.init(tp)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2, seed=1))
    TS.make_train_step(cfg, TO.AdamWConfig(lr=1e-3))(tp, topt, data.batch(0))
    path = str(tmp_path / "step_1.msgpack")
    TC.save({"params": tp, "opt": topt}, path)
    got = JC.restore(jstate, path)
    _assert_bit_equal({"params": tp.tree(), "opt": topt}, got)
    assert got["opt"]["step"].dtype == jnp.int32 and int(got["opt"]["step"]) == 1


def test_restore_in_place_keeps_the_tensors(tmp_path):
    """``inplace=True`` copies into the template's own tensors (the
    launcher resumes a model this way), leaf by leaf."""
    cfg = get_config("stablelm-3b").reduced()
    a = TM.init_params(cfg, 0, torch.float32, max_seq=8, device="cpu")
    b = TM.init_params(cfg, 1, torch.float32, max_seq=8, device="cpu")
    path = str(tmp_path / "p.msgpack")
    TC.save(a, path)
    ptrs = [t.data_ptr() for _, t in _flatten(b)]
    assert TC.restore(b, path, inplace=True) is b
    assert [t.data_ptr() for _, t in _flatten(b)] == ptrs
    for (_, x), (_, y) in zip(_flatten(a), _flatten(b)):
        assert torch.equal(x, y)


def test_restore_checks_keys_shapes_and_dtypes(tmp_path):
    path = str(tmp_path / "t.msgpack")
    TC.save({"w": torch.zeros(2, 3), "s": torch.zeros((), dtype=torch.int32)},
            path)
    with pytest.raises(ValueError, match="w"):
        TC.restore({"w": torch.zeros(3, 2), "s": torch.zeros(
            (), dtype=torch.int32)}, path)
    with pytest.raises(ValueError, match="s"):
        TC.restore({"w": torch.zeros(2, 3), "s": torch.zeros(())}, path)
    with pytest.raises(KeyError, match="extra"):
        TC.restore({"w": torch.zeros(2, 3), "extra": torch.zeros(1)}, path)


def test_failed_save_leaves_no_file(tmp_path):
    """The write is atomic: a save that fails part way (an unsupported
    dtype after a good leaf) leaves neither the file nor a temporary."""
    path = tmp_path / "step_3.msgpack"
    with pytest.raises(TypeError):
        TC.save({"a": torch.ones(4), "b": torch.ones(2, dtype=torch.complex64)},
                str(path))
    assert list(tmp_path.iterdir()) == []
    assert TC.latest_step(str(tmp_path)) is None


def test_encoder_matches_msgpack_at_every_length_boundary():
    """The subset's encoder against ``msgpack.packb(use_bin_type=True)`` at
    the edges of each format (fix / 8 / 16 / 32-bit lengths and ints)."""
    import msgpack
    for n in (0, 15, 16, 2**16 - 1, 2**16):
        assert TC._array(n) == msgpack.packb([0] * n)[:len(TC._array(n))]
    for n in (0, 31, 32, 255, 256, 65535, 65536):
        assert TC._str("k" * n) == msgpack.packb("k" * n, use_bin_type=True)
        assert TC._bin_head(n) + b"\0" * n == msgpack.packb(
            b"\0" * n, use_bin_type=True)
    for v in (0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -1,
              -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31 - 1):
        assert TC._int(v) == msgpack.packb(v), v


def test_save_and_restore_without_msgpack(tmp_path):
    """In a process where ``import msgpack`` fails (as on the card's
    machine), the port still writes and reads checkpoints; the JAX package
    reads the file afterwards."""
    path = tmp_path / "step_2.msgpack"
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "import torch\n"
        "from repro_torch.train import checkpoint as C\n"
        "t = {'a': torch.arange(6, dtype=torch.float32).reshape(2, 3),\n"
        "     'b': [torch.ones(2, dtype=torch.bfloat16)],\n"
        "     'step': torch.tensor(2, dtype=torch.int32)}\n"
        f"C.save(t, {str(path)!r})\n"
        f"r = C.restore(t, {str(path)!r})\n"
        "assert all(torch.equal(r[k], t[k]) for k in ('a', 'step'))\n"
        "assert torch.equal(r['b'][0], t['b'][0])\n"
        f"assert C.latest_step({str(tmp_path)!r}) == 2\n"
        "try:\n"
        "    import msgpack\n"
        "    print('msgpack imported')\n"
        "except ImportError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    got = JC.restore({"a": jnp.zeros((2, 3)), "b": [jnp.zeros(2, jnp.bfloat16)],
                      "step": jnp.zeros((), jnp.int32)}, str(path))
    np.testing.assert_array_equal(np.asarray(got["a"]),
                                  np.arange(6, dtype="f").reshape(2, 3))
    assert int(got["step"]) == 2


# -- copied from tests/test_substrate.py ---------------------------------------

def test_checkpoint_roundtrip_bitexact(tmp_path):
    cfg = get_config("stablelm-3b").reduced()
    params = TM.init_params(cfg, 0, torch.float32, max_seq=16, device="cpu")
    path = os.path.join(tmp_path, "step_5.msgpack")
    TC.save({"params": params}, path)
    restored = TC.restore({"params": params.tree()}, path)["params"]
    for (_, a), (_, b) in zip(_flatten(params), _flatten(restored)):
        np.testing.assert_array_equal(a.detach().numpy(), b.numpy())
    assert TC.latest_step(str(tmp_path)) == 5


def test_train_resume_matches_continuous(tmp_path):
    """Stop at step 2, restore, continue -> the params of running straight
    through (the reference's test, on the port)."""
    cfg = get_config("mamba2-780m").reduced()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, seed=0))
    opt_cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = TS.make_train_step(cfg, opt_cfg)

    def run(n0, n1, params, opt):
        for s in range(n0, n1):
            params, opt, _ = step(params, opt, data.batch(s))
        return params, opt

    def fresh():
        p = TM.trainable(TM.init_params(cfg, 0, torch.float32, max_seq=16,
                                        device="cpu"))
        return p, TO.init(p)

    p_straight, _ = run(0, 4, *fresh())
    p_mid, o_mid = run(0, 2, *fresh())
    TC.save({"p": p_mid, "o": o_mid}, os.path.join(tmp_path, "step_2.msgpack"))
    p_new, o_new = fresh()
    st = TC.restore({"p": p_new.tree(), "o": o_new},
                    os.path.join(tmp_path, "step_2.msgpack"), inplace=True)
    p_resumed, _ = run(2, 4, p_new, st["o"])
    for (_, a), (_, b) in zip(_flatten(p_straight), _flatten(p_resumed)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)
