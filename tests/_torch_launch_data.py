"""The reference's dry-run records as data: ``tests/data/launch_ref.json``,
the subprocesses of ``tests/_torch_launch_ref.py`` that make them, and
the parity policy that holds the port's records to them.

  PYTHONPATH=src python tests/_torch_launch_data.py [--full]

writes the file: (a) ``reduced`` — every ``reduced()`` config × train /
prefill / decode on a (2, 4) ``data`` × ``model`` mesh, seq 32 × batch 8;
(b) ``sharded_cache`` — every ``reduced()`` config's decode, and
stablelm-3b's with a sliding window, at seq 128 × batch 8 with the cache
policy patched so that the cache shards its sequence over ``model``;
(d) ``float32`` — (a) with float32 parameters and cache; all with the
stack unrolled (~1 minute). With ``--full`` also (c) ``full`` — the
records of ``FULL`` at full width and depth on the production meshes,
depth-extrapolated (~10 minutes); without it, (c) is kept from the file.

The tests compare (a), (b) and (d) with the same records made live
(``tests/test_torch_launch_parity.py``, ``tests/test_torch_launch_cache.py``);
``chip_smoke.py``'s ``launch`` phase holds the port's dry run on the card's
torch to all four, with :func:`parity` and :func:`full_parity`.
"""
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PATH = ROOT / "tests" / "data" / "launch_ref.json"
SCRIPT = ROOT / "tests" / "_torch_launch_ref.py"
MESH = (2, 4)
SEQ, BATCH = 32, 8
# the sequence-sharded cache: at seq 128 on (2, 4) a reduced config's
# trailing head / rank slices (16 or fewer) fall below CACHE_MIN_SLICE and
# the sequence's (32) does not
SHARDED_SEQ = 128
SHARDED_MIN_SLICE = 24
WINDOW = 96  # ARCH+window: the config with this sliding window
SHARDED_EXTRA = ("stablelm-3b+window",)
# the reference's runs, balanced by its compile times (jamba alone ~30 s)
GROUPS = (("jamba-v0.1-52b",),
          ("deepseek-v2-236b", "kimi-k2-1t-a32b", "chatglm3-6b"),
          ("whisper-small", "mamba2-780m", "starcoder2-3b"),
          ("internvl2-26b", "stablelm-3b", "internlm2-20b"))
DENSE = ("stablelm-3b", "starcoder2-3b", "internlm2-20b", "chatglm3-6b")
COMPARED = ("dot_flops_per_device", "flops_per_device", "bytes_per_device",
            "bytes_recounted_per_device", "bytes_less_layout_per_device",
            "collectives", "collective_bytes_total", "memory")
FULL = (("deepseek-v2-236b", "train_4k", "single"),
        ("kimi-k2-1t-a32b", "train_4k", "single"),
        ("stablelm-3b", "decode_32k", "multi"))
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}

# -- the parity policy: a port record against the reference's --------------
FLOPS_BAND = (0.99, 1.07)   # FLOPs a device over the reference's dot FLOPs
FLOPS_DENSE_MAX = 1.01      # ... for a dense config: every product split
FLOPS_ALL_MAX = 1.25        # ... over its whole cost_analysis count
COLL_MAX = (2.0, 2.5)       # collective bytes over the reference's: dense,
#                             others
BYTES_MIN = 0.9             # float32 records: bytes a device over the
#                             reference's bytes less its layout ops
RECOUNT_TOL = 0.01          # the recount against XLA's bytes accessed
# full size (FULL's records): the gate of each, and for FLOPs the port's
# measured ratio to the reference's raw dot FLOPs, which count the dots
# GSPMD runs on the whole global batch once a data rank (Queue 3 aa),
# pinned within FULL_RAW_TOL
FULL_GATE = {"deepseek-v2-236b": "flops", "kimi-k2-1t-a32b": "flops",
             "stablelm-3b": "collectives"}
FULL_RAW_FLOPS = {"deepseek-v2-236b": 0.4720, "kimi-k2-1t-a32b": 0.7617}
FULL_RAW_TOL = 0.03
MODEL_WAYS = 16             # the production meshes' model axis
# the reference's attention score and value products (models/attention.py):
# the only dots a full record may count on the whole global batch (see
# attention_dot)
ATTENTION_EINSUMS = frozenset({
    "btkrh,bskh->bkrts", "bkrts,bskh->btkrh",                  # _sdpa
    "bthr,bsr->bhts", "bthc,bsc->bhts", "bhts,bsr->bthr",      # MLA absorbed
    "bthc,bshc->bhts", "bhts,bshc->bthc"})                     # MLA expanded


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def spawn(out_dir, sharded_cache=False, float32=False):
    """Starts the reference's reduced runs, one process a group of
    :data:`GROUPS`: [(process, its output file)]."""
    out_dir = pathlib.Path(out_dir)
    procs = []
    for i, group in enumerate(GROUPS):
        archs = list(group)
        seq, flag = SEQ, []
        if sharded_cache:
            archs += [a for a in SHARDED_EXTRA if a.split("+")[0] in group]
            seq, flag = SHARDED_SEQ, ["--sharded-cache"]
        if float32:
            flag.append("--float32")
        out = out_dir / f"ref{'_sc' if sharded_cache else ''}" \
            f"{'_f32' if float32 else ''}{i}.json"
        procs.append((subprocess.Popen(
            [sys.executable, str(SCRIPT), str(out), *map(str, MESH),
             str(seq), str(BATCH), ",".join(archs), *flag], cwd=ROOT,
            env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True), out))
    return procs


def collect(procs, timeout=300):
    """The records of :func:`spawn`'s processes, keyed (arch, kind, tag)."""
    for p, _ in procs:
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-3000:]
    recs = {}
    for _, out in procs:
        for rec in json.loads(out.read_text()):
            assert rec["status"] == "ok", rec.get("traceback")
            recs[rec["arch"], rec["kind"], rec["tag"]] = rec
    return recs


def end(procs):
    """Ends whichever of :func:`spawn`'s processes still runs."""
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def same_record(a, b):
    """Whether two records agree in every number the reference's dry run
    gives (its compile times aside)."""
    return all(a.get(k) == b.get(k) for k in COMPARED)


def dropped_by_jit(cfg, kind, path):
    """Whether ``jax.jit`` drops the argument at ``path`` (argument index,
    then keys) from the reference's step (``keep_unused=False``): it never
    reads it. In decode: weights only the prompt uses (a VLM's projector,
    whisper's encoder and its cross-attention key / value projections) and
    the position where no layer reads it (an attention-free stack); in
    prefill, cache leaves the prompt replaces whole (SSM states, whisper's
    cross-attention cache, a VLM's cache, which its patches and the prompt
    overrun)."""
    arg, keys = path[0], path[1:]
    if kind == "decode":
        if arg == 0:
            return keys[0] in ("projector", "encoder", "enc_pos",
                               "enc_norm") or (
                "cross" in keys and keys[-1] in ("wk", "wv"))
        return arg == 3 and all(ld.mixer == "ssm" for ld in cfg.pattern())
    if kind == "prefill" and arg == 2:
        return keys[-1] in ("conv", "state") or "cross" in keys \
            or cfg.modality == "vision"
    return False


def dropped_bytes(cfg, shape, sizes):
    """The bytes a device of the port's arguments that ``jax.jit`` drops
    (:func:`dropped_by_jit`): the port's record counts every argument.
    ``sizes``: mesh axis -> size."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import sharding as SH
    _, args, _ = D.build_step(cfg, shape)
    specs = D.arg_shardings(cfg, shape, args, sizes, False)
    dropped = 0

    def walk(tree, spec, path):
        nonlocal dropped
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k], path + (k,))
        elif isinstance(tree, (list, tuple)) and not isinstance(tree, SH.Spec):
            for i, (t, s) in enumerate(zip(tree, spec)):
                walk(t, s, path + (i,))
        elif dropped_by_jit(cfg, shape.kind, path):
            dropped += tree.dtype.itemsize * math.prod(
                SH.local_shape(tree.shape, spec, sizes))
    walk(list(args), list(specs), ())
    return dropped


def load():
    return json.loads(PATH.read_text())


def keyed(section):
    """A section's records keyed (arch, kind, tag)."""
    return {(r["arch"], r["kind"], r["tag"]): r for r in section["records"]}


# each section's setting, as the file states it beside its records
SECTIONS = {
    "reduced": {"mesh": list(MESH), "seq": SEQ, "batch": BATCH,
                "method": "reduced() configs, the stack unrolled"},
    "sharded_cache": {
        "mesh": list(MESH), "seq": SHARDED_SEQ, "batch": BATCH,
        "cache_repl_threshold_bytes": 0,
        "cache_min_slice": SHARDED_MIN_SLICE, "window": WINDOW,
        "method": "reduced() configs' decode, the stack unrolled, the "
                  "cache's sequence sharded over model"},
    "float32": {"mesh": list(MESH), "seq": SEQ, "batch": BATCH,
                "dtype": "float32",
                "method": "reduced() configs, the stack unrolled, float32 "
                          "parameters and cache"},
}


@contextlib.contextmanager
def section_policy(section):
    """The port's cache policy and dtypes patched as ``section`` states
    them (:data:`SECTIONS`), restored after."""
    import torch
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    saved = (SH.CACHE_REPL_THRESHOLD_BYTES, SH.CACHE_MIN_SLICE,
             SP.PARAM_DTYPE, SP.CACHE_DTYPE)
    SH.CACHE_REPL_THRESHOLD_BYTES = section.get(
        "cache_repl_threshold_bytes", saved[0])
    SH.CACHE_MIN_SLICE = section.get("cache_min_slice", saved[1])
    if section.get("dtype") == "float32":
        SP.PARAM_DTYPE = SP.CACHE_DTYPE = torch.float32
    try:
        yield
    finally:
        (SH.CACHE_REPL_THRESHOLD_BYTES, SH.CACHE_MIN_SLICE,
         SP.PARAM_DTYPE, SP.CACHE_DTYPE) = saved


def port_record(ref, section):
    """The port's dry run of the reference's record ``ref`` under
    ``section``'s setting, with ``dropped_bytes`` (:func:`dropped_bytes`)
    beside its numbers."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun as D
    cfg = get_config(ref["arch"]).reduced()
    if ref["tag"] == "window":
        cfg = dataclasses.replace(cfg, sliding_window=section["window"])
    shape = InputShape(ref["shape"], section["seq"], section["batch"],
                       ref["kind"])
    axes = ("data", "model")
    with section_policy(section):
        rec = D.run_one(ref["arch"], ref["shape"], False, cfg=cfg,
                        out_dir="", tag=ref["tag"],
                        mesh_shape=(tuple(section["mesh"]), axes),
                        input_shape=shape)
        if rec["status"] == "ok":
            rec["dropped_bytes"] = dropped_bytes(
                cfg, shape, dict(zip(axes, section["mesh"])))
    return rec


def parity(p, r, bytes_gated=False):
    """The port's record ``p`` (:func:`port_record`) against the
    reference's ``r``: (ratios, the names of the checks it fails). FLOPs a
    device in :data:`FLOPS_BAND` of the reference's dot FLOPs (at most
    :data:`FLOPS_DENSE_MAX` for a dense config) and at most
    :data:`FLOPS_ALL_MAX` of its whole count; collective bytes above 0 and
    at most :data:`COLL_MAX`; argument bytes equal, less what ``jax.jit``
    drops; with ``bytes_gated`` (a float32 record), bytes a device at least
    :data:`BYTES_MIN` of the reference's less its layout ops."""
    dense = r["arch"] in DENSE
    ratios = {
        "flops_over_dots": p["flops_per_device"] / r["dot_flops_per_device"],
        "flops_over_all": p["flops_per_device"] / r["flops_per_device"],
        "collectives_over": p["collective_bytes_total"]
        / r["collective_bytes_total"],
        "argument_bytes": p["memory"]["argument_bytes"] - p["dropped_bytes"],
        "argument_bytes_reference": r["memory"]["argument_bytes"],
        "bytes_over": p["bytes_per_device"] / r["bytes_per_device"],
        "bytes_over_less_layout": p["bytes_per_device"]
        / r["bytes_less_layout_per_device"]}
    checks = {
        "flops": FLOPS_BAND[0] <= ratios["flops_over_dots"] <= (
            FLOPS_DENSE_MAX if dense else FLOPS_BAND[1])
        and ratios["flops_over_all"] <= FLOPS_ALL_MAX,
        "collectives": p["collective_bytes_total"] > 0
        and ratios["collectives_over"] <= COLL_MAX[not dense],
        "argument_bytes": ratios["argument_bytes"]
        == ratios["argument_bytes_reference"],
        "bytes": not bytes_gated
        or ratios["bytes_over_less_layout"] >= BYTES_MIN}
    return ratios, [k for k, ok in checks.items() if not ok]


def attention_dot(dot, rec):
    """Whether a whole-batch dot of the full record ``rec``
    (``whole_batch_dots``) is an attention score or value product: its
    einsum is one of :data:`ATTENTION_EINSUMS`, or, where XLA made the dot
    and named none, one of its arrays is the score tensor, B × H × T × S
    elements (the global batch, the heads a ``model`` rank holds, the
    sequence twice)."""
    if dot["einsum"]:
        return dot["einsum"] in ATTENTION_EINSUMS
    from repro_torch.configs import INPUT_SHAPES, get_config
    shape = INPUT_SHAPES[rec["shape"]]
    scores = shape.global_batch * get_config(rec["arch"]).n_heads \
        // MODEL_WAYS * shape.seq_len ** 2
    return scores in [math.prod(dot[k]) for k in ("lhs", "rhs", "out")]


def full_parity(p, r, ways):
    """A full-size port record ``p`` against the reference's ``r`` (a
    :data:`FULL` record), ``ways`` the data-parallel ranks: (ratios, the
    checks it fails). :data:`FULL_GATE` ``flops``: FLOPs a device in
    :data:`FLOPS_BAND` of the reference's dot FLOPs with its whole-batch
    dots split ``ways`` ways, the raw ratio within :data:`FULL_RAW_TOL` of
    :data:`FULL_RAW_FLOPS`, and every whole-batch dot an attention product
    (:func:`attention_dot`); ``collectives``: collective bytes at most
    :data:`COLL_MAX`."""
    whole = r.get("dot_flops_whole_batch_per_device") or 0
    split = r["dot_flops_per_device"] - whole + whole / ways
    ratios = {"flops_over_dots": p["flops_per_device"]
              / r["dot_flops_per_device"],
              "flops_over_split_dots": p["flops_per_device"] / split,
              "reference_dot_flops_batch_split": split,
              "collectives_over": p["collective_bytes_total"]
              / r["collective_bytes_total"]}
    if FULL_GATE[r["arch"]] == "collectives":
        ok = {"collectives": ratios["collectives_over"]
              <= COLL_MAX[r["arch"] not in DENSE]}
    else:
        dots = r.get("whole_batch_dots") or []
        ok = {"flops": FLOPS_BAND[0] <= ratios["flops_over_split_dots"]
              <= FLOPS_BAND[1],
              "raw_flops": abs(ratios["flops_over_dots"]
                               / FULL_RAW_FLOPS[r["arch"]] - 1)
              <= FULL_RAW_TOL,
              "whole_batch_dots": bool(dots) == bool(whole) and all(
                  attention_dot(d, r) for d in dots)}
    return ratios, [k for k, good in ok.items() if not good]


# -- records that must not follow Python's string hashing -------------------
# the MoE records whose layout DTensor once chose by the hash of strings
# (ROADMAP Queue 3 ac): (arch, kind) of the reduced section
HASHSEED_RECORDS = (("deepseek-v2-236b", "train"),
                    ("deepseek-v2-236b", "prefill"),
                    ("deepseek-v2-236b", "decode"),
                    ("kimi-k2-1t-a32b", "train"),
                    ("jamba-v0.1-52b", "train"))
HASHSEEDS = (0, 7)
HASHSEED_COMPARED = ("flops_per_device", "bytes_per_device", "collectives",
                     "collective_bytes_total", "memory")


def hashseed_records():
    """The port's dry run of :data:`HASHSEED_RECORDS` under the reduced
    section's setting: {"arch/kind": the numbers of
    :data:`HASHSEED_COMPARED`}."""
    refs = keyed(load()["reduced"])
    out = {}
    for arch, kind in HASHSEED_RECORDS:
        (ref,) = [r for (a, k, _), r in refs.items()
                  if (a, k) == (arch, kind)]
        rec = port_record(ref, SECTIONS["reduced"])
        assert rec["status"] == "ok", rec.get("traceback")
        out[f"{arch}/{kind}"] = {k: rec[k] for k in HASHSEED_COMPARED}
    return out


def spawn_hashseed(seed, out, env=None):
    """:func:`hashseed_records` in a process of its own with
    ``PYTHONHASHSEED=seed``, written to ``out`` (``python
    tests/_torch_launch_data.py --hashseed OUT``)."""
    return subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--hashseed",
         str(out)], cwd=ROOT,
        env={**(env or _env()), "PYTHONHASHSEED": str(seed)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def hashseed_differences(a, b):
    """The records of two :func:`hashseed_records` that differ, with the
    numbers that do: {"arch/kind": {name: (a's, b's)}}."""
    return {key: {k: (a[key][k], b[key].get(k)) for k in a[key]
                  if a[key][k] != b[key].get(k)}
            for key in sorted(a) if a[key] != b.get(key)}


def main(argv=None):
    import tempfile
    argv = sys.argv[1:] if argv is None else argv
    old = load() if PATH.exists() else {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {"reduced": spawn(tmp),
                 "sharded_cache": spawn(tmp, sharded_cache=True)}
        try:
            recs = {k: collect(v) for k, v in procs.items()}
            procs["float32"] = spawn(tmp, float32=True)
            recs["float32"] = collect(procs["float32"])
        finally:
            end([p for v in procs.values() for p in v])
        full = old.get("full")
        if "--full" in argv:
            got = []
            for arch, shape, mesh in FULL:  # one at a time: 256 / 512 devices
                out = pathlib.Path(tmp) / f"full_{arch}_{shape}.json"
                subprocess.run([sys.executable, str(SCRIPT), str(out),
                                "--full", arch, shape, mesh], cwd=ROOT,
                               env=_env(), check=True)
                got += json.loads(out.read_text())
            full = {"method": got[0]["method"], "records": got}
    import jax
    data = {
        "about": "the reference's (src/repro, jax) dry-run records, "
                 "written by tests/_torch_launch_data.py",
        "jax": jax.__version__,
        **{name: {**SECTIONS[name],
                  "records": sorted(recs[name].values(), key=_order)}
           for name in SECTIONS},
        "full": full,
    }
    PATH.parent.mkdir(parents=True, exist_ok=True)
    PATH.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    print(f"wrote {PATH}")
    return 0


def _order(rec):
    return rec["arch"], rec["kind"], rec["tag"]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--hashseed"]:
        sys.path.insert(0, str(ROOT / "src"))
        pathlib.Path(sys.argv[2]).write_text(json.dumps(hashseed_records()))
        raise SystemExit(0)
    raise SystemExit(main())
