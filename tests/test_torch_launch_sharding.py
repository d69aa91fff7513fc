"""The port's sharding policy (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), leaf by leaf and exactly: every
param / optimizer / batch / cache spec of the ten configs on both
production meshes. The reference needs no devices: its policy reads only
the mesh's axis sizes (the ``_FakeMesh`` style of ``test_substrate.py``).
The DTensor side (``to_placements``, ``distribute``, ``SyntheticLM.shard``)
runs over a fake process group."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.sharding import Spec

ARCHS = list_configs()


def _fake(shape, axes):
    class _FakeMesh:
        axis_names = axes

        class devices:
            pass
    _FakeMesh.devices.shape = shape
    _FakeMesh.devices.size = int(np.prod(shape))
    return _FakeMesh()


MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jflat(tree):
    """{path: spec as a tuple} of a reference spec tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                       for p in path)
        out[key] = tuple(leaf)
    return out


def _tflat(tree):
    out = {}
    SH.tree_map_with_path(
        lambda path, s: out.__setitem__("/".join(map(str, path)), tuple(s)),
        tree)
    return out


def _assert_specs_equal(port, ref):
    a, b = _tflat(port), _jflat(ref)
    assert a.keys() == b.keys()
    bad = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert not bad, bad


@pytest.fixture(scope="module")
def ref_params():
    """Each config's reference param shapes, traced once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = JSP.param_shapes(j_config(arch), max_seq=4096)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_and_opt_specs_equal_reference(arch, mesh, ref_params):
    """fsdp {off, on} × expert_parallel {False, True}, every leaf."""
    shape, axes = MESHES[mesh]
    tm, jm = dict(zip(axes, shape)), _fake(shape, axes)
    tshapes = SP.param_shapes(get_config(arch), max_seq=4096)
    for fsdp in (False, True):
        for ep in (False, True):
            port = SH.param_specs(tshapes, tm, fsdp=fsdp, expert_parallel=ep)
            ref = JSH.param_specs(ref_params(arch), jm, fsdp=fsdp,
                                  expert_parallel=ep)
            _assert_specs_equal(port, ref)
            _assert_specs_equal(SH.opt_specs(port), JSH.opt_specs(ref))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_equal_reference(arch, mesh):
    """At each input shape: the batch (or decode tokens) and the cache,
    with and without the model-axis cache sharding."""
    shape, axes = MESHES[mesh]
    tm, jm = dict(zip(axes, shape)), _fake(shape, axes)
    for sname, ishape in INPUT_SHAPES.items():
        cfg = SP.effective_config(get_config(arch), ishape)
        jcfg = JSP.effective_config(j_config(arch), J_SHAPES[sname])
        B, T = ishape.global_batch, ishape.seq_len
        toks = SP.token_specs(cfg, B, T)
        _assert_specs_equal(SH.batch_specs(toks, tm),
                            JSH.batch_specs(JSP.token_specs(jcfg, B, T), jm))
        if ishape.kind == "train":
            continue
        tcache = SP.cache_shapes(cfg, B, T)
        jcache = JSP.cache_shapes(jcfg, B, T)
        for model_shard in (True, False):
            _assert_specs_equal(SH.cache_specs(tcache, tm, model_shard),
                                JSH.cache_specs(jcache, jm, model_shard))


# -- the reference's rule tests (tests/test_substrate.py), on the port -------

MESH = {"data": 16, "model": 16}


def test_param_specs_cover_all_archs():
    """Every param leaf of every arch gets a valid spec (axes exist, sharded
    dims divisible)."""
    for arch in ("starcoder2-3b", "kimi-k2-1t-a32b", "deepseek-v2-236b",
                 "jamba-v0.1-52b", "whisper-small", "mamba2-780m",
                 "internvl2-26b"):
        shapes = SP.param_shapes(get_config(arch), max_seq=128)
        specs = SH.param_specs(shapes, MESH, fsdp=True)

        def check(path, spec):
            leaf = shapes
            for k in path:
                leaf = leaf[k]
            for dim, ax in enumerate(spec):
                if ax is not None:
                    assert leaf.shape[dim] % MESH[ax] == 0, (arch, path, spec)
        SH.tree_map_with_path(check, specs)


def test_row_col_rules():
    spec = SH.param_spec(("mlp", "w_down"), (1024, 4096), MESH)
    assert spec == Spec("model", None)       # row-parallel: contraction dim
    spec = SH.param_spec(("mlp", "w_up"), (4096, 1024), MESH)
    assert spec == Spec(None, "model")       # column-parallel: output dim
    spec = SH.param_spec(("x", "norm_scale"), (4096,), MESH)
    assert spec == Spec(None)                # replicated


def test_batch_spec_divisibility():
    assert SH.batch_spec((256, 4096), MESH) == Spec(("data",), None)
    assert SH.batch_spec((1, 4096), MESH) == Spec(None, None)  # batch=1


def test_projector_row_parallel():
    """The modality projector is row-parallel, so the residual stream
    enters layer 0 replicated over 'model'."""
    spec = SH.param_spec(("projector", "w"), (3200, 6144), MESH)
    assert spec == Spec("model", None)


def test_expert_parallel_variant():
    path = ("layers", "mlp", "w_gate")
    base = SH.param_spec(path, (61, 384, 7168, 2048), MESH)
    assert base == Spec(None, None, None, "model")   # TP baseline
    ep = SH.param_spec(path, (61, 384, 7168, 2048), MESH,
                       expert_parallel=True)
    assert ep == Spec(None, "model", None, None)     # expert-parallel


def test_vocab_fallback():
    """internvl2 vocab 92553 is NOT divisible by 16: the embedding falls
    back to sharding d_model."""
    spec = SH.param_spec(("embed",), (92553, 6144), MESH)
    assert spec == Spec(None, "model")


def test_axis_sizes_of_each_mesh_kind():
    jm = _fake((2, 16, 16), ("pod", "data", "model"))
    want = {"pod": 2, "data": 16, "model": 16}
    assert TMESH.axis_sizes(jm) == want == TMESH.axis_sizes(want)
    assert TMESH.data_axes(jm) == ("pod", "data")


# -- placements over a fake process group -------------------------------------

@pytest.fixture
def fake8():
    with TMESH.fake_world(8):
        yield TMESH.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")


def test_to_placements_orders_shards_by_mesh_dim(fake8):
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake8
    assert SH.to_placements(Spec(("pod", "data"), None), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert SH.to_placements(Spec(None, "model", "data"), mesh) == \
        (Replicate(), Shard(2), Shard(1))
    assert SH.to_placements(Spec(None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        SH.to_placements(Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        SH.to_placements(Spec("model", "model"), mesh)


def test_distribute_meta_tree_allocates_nothing(fake8):
    mesh = fake8
    tree = SP.meta({"a": SP.TensorSpec((8, 6), torch.bfloat16),
                    "b": [SP.TensorSpec((4, 2, 8), torch.float32)]})
    specs = {"a": Spec(("pod", "data"), None),
             "b": [Spec(None, "model", "pod")]}
    dt = SH.distribute(tree, specs, mesh)
    assert dt["a"].shape == (8, 6) and dt["a"].to_local().shape == (2, 6)
    assert dt["b"][0].to_local().shape == (4, 1, 4)
    assert dt["a"].to_local().is_meta
    assert SH.local_shape((8, 6), specs["a"], mesh) == (2, 6)


def test_synthetic_lm_shard_on_fake_mesh(fake8):
    """Each array of a batch onto the (2,2,2) mesh with batch_spec's
    placements: rank 0 holds rows 0-1 of 8 (pod × data = 4 shards)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    data = SyntheticLM(DataConfig(vocab_size=50, seq_len=5, global_batch=8))
    batch = data.batch(3)
    out = data.shard(batch, fake8)
    for k, v in out.items():
        assert isinstance(v, DTensor)
        assert v.placements == (Shard(0), Shard(0), Replicate())
        assert v.shape == (8, 5)
        np.testing.assert_array_equal(v.to_local().numpy(), batch[k][:2])
    odd = SyntheticLM(DataConfig(vocab_size=50, seq_len=5, global_batch=3))
    rep = odd.shard(odd.batch(0), fake8)["tokens"]
    assert rep.placements == (Replicate(),) * 3
    assert rep.to_local().shape == (3, 5)


# -- the launcher's production meshes -----------------------------------------

def test_train_on_production_mesh_trains_as_local(capsys):
    """``--mesh single`` under a 256-rank (fake) world computes every
    parameter's placements and does not apply them, as the reference's
    launcher (ROADMAP Queue 3 v): the losses are ``--mesh local``'s."""
    from repro_torch.launch import train
    argv = ["--arch", "stablelm-3b-smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--log-every", "1"]
    local = train.main(argv)
    with TMESH.fake_world(256):
        single = train.main(argv + ["--mesh", "single"])
        with pytest.raises(RuntimeError, match="512"):
            train.main(argv + ["--mesh", "multi"])
    assert single == local
    out = capsys.readouterr().out
    assert "mesh single {'data': 16, 'model': 16}" in out
    assert "not applied" in out


def test_local_mesh_starts_a_one_rank_group():
    """``make_local_mesh`` starts a one-rank gloo group over a FileStore
    when none is active, and refuses a group of another size."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = TMESH.make_local_mesh("cpu")
        assert TMESH.axis_sizes(mesh) == {"data": 1, "model": 1}
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    with TMESH.fake_world(8):
        with pytest.raises(RuntimeError, match="needs 1 ranks"):
            TMESH.make_local_mesh("cpu")
