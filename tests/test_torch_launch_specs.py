"""The port's abstract input specs (``repro_torch.launch.specs``) against
the reference's (``repro.launch.specs``): every leaf of every config at
every input shape has the same path, shape and dtype; nothing is
allocated."""
import jax
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.launch import specs as JSP
from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                       for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _tflat(tree):
    out = {}

    def add(path, s):
        assert isinstance(s, SP.TensorSpec), type(s)
        out["/".join(map(str, path))] = (tuple(s.shape),
                                        str(s.dtype).removeprefix("torch."))
    SH.tree_map_with_path(add, tree)
    return out


@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_equal_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        port = _tflat(SP.input_specs(get_config(arch), shape))
        ref = _jflat(JSP.input_specs(j_config(arch), J_SHAPES[name]))
        assert port.keys() == ref.keys(), (name, port.keys() ^ ref.keys())
        bad = {k: (port[k], ref[k]) for k in port if port[k] != ref[k]}
        assert not bad, (name, bad)


def test_input_specs_allocate_nothing():
    """Specs are shapes and dtypes; their meta tensors hold no storage."""
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    specs = SP.input_specs(get_config("kimi-k2-1t-a32b"),
                           INPUT_SHAPES["train_4k"])
    leaves = []
    SH.tree_map_with_path(lambda _, s: leaves.append(s), specs)
    assert all(isinstance(s, SP.TensorSpec) for s in leaves)
    assert sum(s.nbytes for s in leaves) > 1e12  # a 1T model and its moments
    metas = []
    SH.tree_map_with_path(lambda _, t: metas.append(t), SP.meta(specs))
    assert len(metas) == len(leaves) and all(t.is_meta for t in metas)
    after = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    assert after == before


def test_long_500k_window_and_state():
    cfg = get_config("starcoder2-3b")
    s = SP.input_specs(cfg, INPUT_SHAPES["decode_32k"])
    assert s["tokens"].shape == (128, 1)
    # full-attention arch on long_500k: cache capacity = sliding window
    s = SP.input_specs(cfg, INPUT_SHAPES["long_500k"])
    kv = []
    SH.tree_map_with_path(lambda _, l: kv.append(l), s["cache"])
    assert kv and all(l.shape[2] == SP.SLIDING_WINDOW_500K for l in kv
                      if len(l.shape) == 5)
    assert SP.effective_config(cfg, INPUT_SHAPES["long_500k"]) \
        .sliding_window == SP.SLIDING_WINDOW_500K
    # ssm arch: the cache is O(1) state, no window
    s = SP.input_specs(get_config("mamba2-780m"), INPUT_SHAPES["long_500k"])
    state = []
    SH.tree_map_with_path(lambda _, l: state.append(l.nbytes), s["cache"])
    assert state and max(state) < 1e9


def test_whisper_long_500k_skip_reason():
    for name, shape in INPUT_SHAPES.items():
        for arch in list_configs():
            want = JSP.skip_reason(j_config(arch), J_SHAPES[name])
            assert SP.skip_reason(get_config(arch), shape) == want
    assert SP.skip_reason(get_config("whisper-small"),
                          INPUT_SHAPES["long_500k"]).startswith(
                              "enc-dec decoder context")


def test_materialize_is_seeded():
    specs = {"w": SP.TensorSpec((4, 3), torch.bfloat16),
             "t": SP.TensorSpec((2,), torch.int32)}
    a, b = SP.materialize(specs, "cpu", 1), SP.materialize(specs, "cpu", 1)
    assert torch.equal(a["w"], b["w"]) and a["w"].dtype == torch.bfloat16
    assert a["t"].dtype == torch.int32 and int(a["t"].max()) < 2
