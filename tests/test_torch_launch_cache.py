"""A decode step over a sequence-sharded cache: the port's dry run against
the reference's, and against the committed records.

``sharding.cache_spec`` shards a cache leaf's sequence over ``model``
(flash-decode style) once the leaf passes ``CACHE_REPL_THRESHOLD_BYTES``
and its trailing head or rank dimensions are too narrow to shard. The
production decode_32k caches do (stablelm-3b on 2×16×16); the reduced
configs at the parity test's seq 32 never pass the threshold. So both
packages run here with the policy patched (the reference's inside its
subprocesses, ``tests/_torch_launch_ref.py --sharded-cache``): threshold
0, ``CACHE_MIN_SLICE`` above the trailing dimensions' slices and at most
the sequence's, seq 128 × batch 8 on the (2, 4) mesh; every ``reduced()``
config's decode, and stablelm-3b's with a sliding window.

The fault these hold (the dry run before ``write_rows``): ``attention.py``
wrote the new token's key and value by slicing the cache,
``cache[:, slot:slot + 1]``, which cuts the sharded sequence, and the dry
run gathered the whole cache to take the slice (stablelm-3b: 8.6× the reference's collective bytes at
this size, 43.5 GB a device a step at full size). Now the write is
``attention.write_rows``, which the dry run runs on the shard that holds
the rows, and attention over the sharded cache all-reduces only the
softmax's statistics and the weighted sums (``dryrun._over_sequence``).
"""
import dataclasses
import math

import pytest

import _torch_launch_data as LD
from repro_torch.configs import InputShape, get_config, list_configs
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH

SECTION = LD.SECTIONS["sharded_cache"]
MESH = (LD.MESH, ("data", "model"))
SIZES = dict(zip(MESH[1], MESH[0]))
SHAPE = InputShape("decode_32k", LD.SHARDED_SEQ, LD.BATCH, "decode")
CASES = [(a, "") for a in list_configs()] + [
    tuple(a.split("+")) for a in LD.SHARDED_EXTRA]


def _cfg(arch, tag):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, sliding_window=LD.WINDOW) \
        if tag == "window" else cfg


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(port, reference, the output bytes of each all-gather the port's
    step issued), keyed (arch, tag)."""
    procs = LD.spawn(tmp_path_factory.mktemp("launch_ref_sc"),
                     sharded_cache=True)
    port, gathers = {}, {}
    spy_into = []
    dispatch = D.StepMeter.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        if out is not NotImplemented and not self.paused \
                and func.namespace == "_c10d_functional" \
                and func._overloadpacket.__name__.startswith("all_gather"):
            spy_into.append(sum(D._nbytes(t) for t in D._tensors(out)))
        return out
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(D.StepMeter, "__torch_dispatch__", spy)
            for arch, tag in CASES:
                spy_into.clear()
                rec = LD.port_record({"arch": arch, "shape": "decode_32k",
                                      "kind": "decode", "tag": tag}, SECTION)
                assert rec["status"] == "ok", rec.get("traceback")
                port[arch, tag] = rec
                gathers[arch, tag] = list(spy_into)
        ref = LD.collect(procs)
    finally:
        LD.end(procs)
    ref = {(a, t): r for (a, _, t), r in ref.items()}
    assert set(ref) == set(port)
    return port, ref, gathers


def _cache_leaves(arch, tag):
    """(path, shape, spec, itemsize) of every cache leaf under the patched
    policy."""
    with LD.section_policy(SECTION):
        _, args, _ = D.build_step(_cfg(arch, tag), SHAPE)
        specs = SH.cache_specs(args[2], SIZES)
    out = []

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k], path + (k,))
        elif isinstance(tree, (list, tuple)) and not isinstance(tree, SH.Spec):
            for i, (t, s) in enumerate(zip(tree, spec)):
                walk(t, s, path + (i,))
        else:
            out.append((path, tuple(tree.shape), tuple(spec),
                        tree.dtype.itemsize))
    walk(args[2], specs, ())
    return out


@pytest.mark.parametrize("arch,tag", CASES)
def test_attention_caches_shard_their_sequence(arch, tag):
    """What the patch is for: every self-attention cache leaf
    (n_periods, B, S, ...) shards S over ``model``."""
    leaves = [(path, spec) for path, _, spec, _ in _cache_leaves(arch, tag)
              if path[-1] in ("k", "v", "ckv", "krope")
              and "cross" not in path]
    if all(ld.mixer == "ssm" for ld in _cfg(arch, tag).pattern()):
        assert not leaves
        return
    assert leaves
    for path, spec in leaves:
        assert spec[2] == "model", (path, spec)


@pytest.mark.parametrize("arch,tag", CASES)
def test_committed_sharded_cache_records_are_the_live_ones(records, arch,
                                                           tag):
    _, ref, _ = records
    committed = LD.keyed(LD.load()["sharded_cache"])[arch, "decode", tag]
    assert LD.same_record(committed, ref[arch, tag])


@pytest.mark.parametrize("arch,tag", CASES)
def test_sharded_cache_argument_bytes_equal_the_references(records, arch,
                                                           tag):
    """Equal argument bytes: both packages shard the cache alike."""
    port, ref, _ = records
    p = port[arch, tag]
    assert p["memory"]["argument_bytes"] \
        == p["memory"]["argument_bytes_by_specs"]
    ratios, failed = LD.parity(p, ref[arch, tag])
    assert "argument_bytes" not in failed, (ratios, p["dropped_bytes"])


@pytest.mark.parametrize("arch,tag", CASES)
def test_sharded_cache_collectives_within_the_references(records, arch, tag):
    port, ref, _ = records
    p, r = port[arch, tag], ref[arch, tag]
    ratios, failed = LD.parity(p, r)
    print(f"{arch} {tag}: collective bytes {p['collective_bytes_total']} / "
          f"{r['collective_bytes_total']} = {ratios['collectives_over']:.3f}")
    assert "collectives" not in failed, \
        (ratios, p["collectives"], p["fallback_ops"])


@pytest.mark.parametrize("arch,tag", CASES)
def test_sharded_cache_is_never_gathered(records, arch, tag):
    """No all-gather as large as one period's slice of a cache leaf that
    ``model`` shards, gathered over ``model``; and a sequence-sharded
    cache is written where it lies (``fallback_ops``)."""
    port, _, gathers = records
    sharded = [(shape, spec, size) for _, shape, spec, size
               in _cache_leaves(arch, tag) if "model" in spec]
    if not sharded:
        return
    leaf = min(math.prod(SH.local_shape(shape, spec, SIZES)[1:])
               * SIZES["model"] * size for shape, spec, size in sharded)
    assert max(gathers[arch, tag], default=0) < leaf, \
        (sorted(gathers[arch, tag])[-3:], leaf)
    if any(spec[2] == "model" for _, spec, _ in sharded):
        assert "write_rows (on its shard)" in port[arch, tag]["fallback_ops"]


@pytest.mark.parametrize("arch,tag", CASES)
def test_sharded_cache_flops_split_as_the_references(records, arch, tag):
    port, ref, _ = records
    ratios, failed = LD.parity(port[arch, tag], ref[arch, tag])
    assert "flops" not in failed, ratios
