"""The dry run's MoE records do not follow Python's string hashing.

DTensor's rules gave the MoE combine several layouts of equal cost, and
which one a run took followed the hash of strings: reduced deepseek-v2's
``train_4k`` record read 166,798,766 B a device under ``PYTHONHASHSEED`` 0
and 162,731,438 B under 7. ``dryrun.reference_layout`` now gives the
combine one layout (``dryrun._split_combine``). One process a seed
dry-runs the five MoE records of ``_torch_launch_data.HASHSEED_RECORDS``
(the reduced section's setting: (2, 4), seq 32 × batch 8), and every number
of ``HASHSEED_COMPARED`` must agree: FLOPs, bytes, collectives by kind,
argument / output / temp bytes.
"""
import json

from _torch_launch_data import (HASHSEED_RECORDS, HASHSEEDS,
                                hashseed_differences, spawn_hashseed)


def test_moe_records_equal_under_every_hash_seed(tmp_path):
    outs = [tmp_path / f"seed{s}.json" for s in HASHSEEDS]
    procs = [spawn_hashseed(s, out) for s, out in zip(HASHSEEDS, outs)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    a, b = (json.loads(out.read_text()) for out in outs)
    assert sorted(a) == sorted(f"{arch}/{kind}"
                               for arch, kind in HASHSEED_RECORDS)
    assert hashseed_differences(a, b) == {}
