#!/usr/bin/env bash
# Gate for the PyTorch/CUDA port (src/repro_torch), on the CPU:
#   1. the plan auditor's selftest: the seeded bad plans are still caught
#   2. the fault-injection selftest: the chaos harness's scripted
#      scenarios through the port's resilience layer on a fake clock
#   3. the observability selftest: span trees, flight dump and the
#      OpenMetrics exposition through the port's serving pipeline
#   4. the port's tests by path (tests/test_torch_*.py, the JAX package
#      beside them as the reference), on pytest-xdist workers when it is
#      installed
# The card's own checks are chip_smoke.py's (python3 chip_smoke.py).
#
#   tools/check_torch.sh [--skip-tests] [pytest args...]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

echo "== plan auditor selftest =="
python -m repro_torch.analysis --selftest --device cpu

echo "== fault-injection selftest =="
python -m repro_torch.serve.faults --selftest

echo "== observability selftest =="
python -m repro_torch.obs --selftest

if [[ "${1:-}" == "--skip-tests" ]]; then
    echo "check_torch.sh: selftests passed (tests skipped)"
    exit 0
fi

echo "== the port's tests =="
workers=()
if python -c "import xdist" >/dev/null 2>&1; then
    workers=(-p xdist -n "${CHECK_TORCH_WORKERS:-6}" --dist loadfile)
fi
python -m pytest -q -p no:cacheprovider "${workers[@]}" tests/test_torch_*.py "$@"

echo "check_torch.sh: all gates passed"
