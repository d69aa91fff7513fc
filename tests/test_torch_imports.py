"""The PyTorch port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py`` or an ``examples/torch_*.py``) imports JAX or the JAX
package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"forbidden modules loaded: {out.stdout}"
    assert len(MODULES) >= 69, MODULES


@pytest.mark.parametrize("module", [
    "repro_torch.core.memory", "repro_torch.core.paging",
    "repro_torch.core.interpreter", "repro_torch.kernels.paged_matmul"])
def test_paged_route_modules_import_alone(module):
    """Each module of the paged route and the reference route, imported
    first and alone, loads neither JAX nor the JAX package."""
    assert module in MODULES
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "print(','.join(sorted(n for n in sys.modules\n"
            "      if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"forbidden modules loaded: {out.stdout}"


@pytest.mark.parametrize("modules", [
    ("repro_torch.serve", "repro_torch.obs"), ("repro_torch.serve.registry",),
    ("repro_torch.serve.resilience",), ("repro_torch.obs.__main__",),
    ("repro_torch.models.model",), ("repro_torch.serve.engine",),
    ("repro_torch.launch.serve",)],
    ids=lambda m: "+".join(m))
def test_serving_modules_import_alone(modules):
    """The serving stack and observability, and the LLM serving path
    (model, session, launcher), imported first and alone, load neither JAX
    nor the JAX package (the scheduler and the resilience layer run on the
    port's engine)."""
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(','.join(sorted(n for n in sys.modules\n"
            "      if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"forbidden modules loaded: {out.stdout}"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)|from\s+(jax|jaxlib|repro)\b(?!_))",
    re.M)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"
