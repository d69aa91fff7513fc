"""The port's example CLIs (``examples/torch_*.py``), each run with
``--device cpu`` in a subprocess, as a user runs them: exit 0 and the
lines their JAX twins print, the "✓" lines among them. On the card
``chip_smoke.py``'s ``examples`` phase runs them."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _run(args, code=None, env=()):
    cmd = ([sys.executable, "-c", code] if code is not None
           else [sys.executable, str(EXAMPLES / args[0]), *args[1:]])
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              **dict(env)})
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_quickstart():
    out = _run(["torch_quickstart.py", "--device", "cpu"])
    assert "engines agree bit-exactly ✓" in out
    assert "saved and reloaded graph runs bit-identically ✓" in out
    for head in ("quantized: 6 ops", "interpreter:", "compiled:", "kernels:",
                 "weights          :", "interpreter arena:",
                 "compiled peak    :", "folded constants :"):
        assert head in out, (head, out)


def test_train_sine():
    """The sine predictor trained, quantized and deployed: the table of
    ``examples/train_sine.py`` (every MSE near the noise floor of
    U(-0.1, 0.1), 0.0033), the int8 engines bit-identical, and the four
    single-sample predictions."""
    out = _run(["torch_train_sine.py", "--device", "cpu"],
               env={"OMP_NUM_THREADS": "2"})
    lines = out.splitlines()
    assert lines[0] == "training the 1-16-16-1 sine MLP ..."
    assert "(paper: 0.0154/0.1241)" in lines[1]
    for row, name in zip(lines[2:5], ("float", "int8_interp",
                                      "int8_compiled")):
        got, mse, rmse = row.split()
        assert got == name and float(mse) <= 0.006, row
        assert abs(float(rmse) - float(mse) ** 0.5) < 1e-3, row
    assert lines[5] == "int8 engines bit-identical: True"
    preds = [ln for ln in lines if ln.startswith("predict sin(")]
    assert len(preds) == 4
    for ln in preds:  # "predict sin(0.50) = +0.471   (true +0.479)"
        y, true = float(ln.split()[3]), float(ln.split()[5].rstrip(")"))
        assert abs(y - true) < 0.1, ln


def test_person_detection():
    """Full-width person at 96×96 on both engines, bit for bit; the timing
    repetitions cut through the module's constant."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(EXAMPLES)!r})\n"
            "import torch_person_detection as ex\n"
            "ex.TIMING_REPS = 3\n"
            "ex.main('cpu')\n")
    out = _run(None, code=code)
    assert "31 operator layers" in out
    assert "engines agree ✓" in out
    for name in ("interpreter", "compiled"):
        assert f"  {name:12s} median" in out, out


@pytest.mark.parametrize("chaos", [False, True], ids=["healthy", "chaos"])
def test_serve_tinyml(chaos):
    """A small burst at sine and speech; with ``--chaos`` behind seeded
    faults (on the CPU the kernels' plain versions are slow enough that
    SLO deadlines fail some requests: what is checked is the report and
    the served-rows check)."""
    out = _run(["torch_serve_tinyml.py", "48", "--device", "cpu"]
               + (["--chaos"] if chaos else []))
    assert "/48 served" in out
    assert "[sine]" in out and "[speech]" in out
    assert ("resilience       injected=" in out) is chaos
    assert "served rows are bit-identical to direct predict_q ✓" in out


def test_serve_llm():
    """Trains stablelm-3b ``-smoke`` a few steps, then serves it in fp32 and
    int8 weight-only: the lines ``examples/serve_llm.py`` prints, the loss
    falling."""
    out = _run(["torch_serve_llm.py", "--steps", "25", "--batch", "4",
                "--max-new", "8", "--device", "cpu"],
               env={"OMP_NUM_THREADS": "2"})  # beside the other workers
    lines = out.splitlines()
    assert lines[0] == "model: stablelm-3b-smoke (2L d=256)", lines
    losses = [float(ln.split()[-1]) for ln in lines
              if ln.startswith("  train step")]
    assert len(losses) == 3 and losses[-1] < losses[0] - 1.0, losses
    for tag in ("fp32", "int8"):
        assert any(ln.startswith(f"[{tag}] 32 tokens in ") and
                   "rule-following" in ln for ln in lines), (tag, lines)
    assert lines[-1].startswith("int8 vs fp32 token agreement: ")
