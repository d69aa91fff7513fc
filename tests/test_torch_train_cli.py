"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: in a subprocess as a user runs it, the loss falls and the log
lines are the reference launcher's; a run resumes from its checkpoint
directory; without a launched world only the one-device mesh, and only
whole periods, are taken. Then ``tests/test_archs.py::
test_smoke_train_step`` copied onto the port (every ``reduced()`` config
takes one step)."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.data.pipeline import frontend_stub
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"^\[train\] step +\d+ loss \d+\.\d{4} lr \d\.\d\de[-+]\d\d "
                       r"gnorm \d+\.\d\d \(\d+\.\ds\)$")


def _train(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "2"},  # beside the other test workers
        capture_output=True, text=True, timeout=300)
    return out


def test_loss_falls_and_lines_match_the_reference():
    out = _train("--arch", "stablelm-3b-smoke", "--steps", "12",
                 "--device", "cpu", "--log-every", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("[train] step")]
    assert len(steps) == 12 and all(STEP_LINE.match(ln) for ln in steps), lines
    done = re.match(r"^\[train\] done: first loss (\S+) last loss (\S+)$",
                    lines[-1])
    assert done and float(done[2]) < float(done[1]) - 0.3, lines[-1]


def test_resumes_from_the_checkpoint_directory(tmp_path, capsys):
    from repro_torch.launch import train
    d = str(tmp_path / "ckpt")
    losses = train.main(["--arch", "mamba2-780m-smoke", "--steps", "4",
                         "--device", "cpu", "--ckpt-dir", d,
                         "--ckpt-every", "2", "--remat"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert sorted(os.listdir(d)) == ["step_2.msgpack", "step_4.msgpack"]
    capsys.readouterr()
    assert len(train.main(["--arch", "mamba2-780m-smoke", "--steps", "6",
                           "--device", "cpu", "--ckpt-dir", d,
                           "--log-every", "1"])) == 2
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[train] resumed from step 4"
    assert [ln.split()[2] for ln in lines if ln.startswith("[train] step")] \
        == ["4", "5"]


def test_only_the_local_mesh_and_whole_periods(capsys):
    """Without a launched world, only the one-device mesh is taken: a
    production mesh needs a process group of its size (256 ranks for
    ``single``), and an unknown mesh is refused."""
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="256 ranks; none is active"):
        train.main(["--arch", "stablelm-3b-smoke", "--mesh", "single",
                    "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "stablelm-3b-smoke", "--mesh", "pods",
                    "--device", "cpu"])
    assert e.value.code == 2
    assert "invalid choice: 'pods'" in capsys.readouterr().err
    with pytest.raises(ValueError, match="multiple of its period"):
        train.main(["--arch", "jamba-v0.1-52b-smoke", "--layers", "3",
                    "--device", "cpu"])


# -- copied from tests/test_archs.py ------------------------------------------

B, T = 2, 16


def _batch(cfg, rng):
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    b.update(frontend_stub(cfg, B, rng))
    return b


@pytest.mark.parametrize("arch", list_configs())
def test_smoke_train_step(arch):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(1)
    params = M.trainable(M.init_params(cfg, 1, torch.float32, max_seq=T,
                                       device="cpu"))
    before = [t.detach().clone() for _, t in _flatten(params)]
    opt_state = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    params2, opt_state2, metrics = step(params, opt_state, _batch(cfg, rng))
    assert bool(torch.isfinite(metrics["loss"])), arch
    assert bool(torch.isfinite(metrics["grad_norm"]))
    # parameters actually moved
    delta = max(float((a - b.detach()).abs().max())
                for a, (_, b) in zip(before, _flatten(params2)))
    assert delta > 0
    assert int(opt_state2["step"]) == 1
