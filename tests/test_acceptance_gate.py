"""Accuracy regression gate as a pytest target.

``pytest -m acceptance`` re-runs the 10-12-32 revisit window on the GPU
through ``scripts/acceptance_gate.py`` and FAILS if drift / ATE / loop
behavior leaves the calibrated bands.  Opt-in (excluded by the default
``-m 'not acceptance'`` addopts) because it needs the GPU and ~5-10
minutes; the gate script itself carries a ``--selftest`` proving it can go
red.  Both tests skip when the gate's inputs (the reference's Oxford YAML
and ground truth) are not on disk.

The run happens in a subprocess with a clean environment because this suite's
conftest pins the CPU backend with 8 virtual devices.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.acceptance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_INPUTS = (
    "/root/reference/ros/ndt_radar_slam/config/parameters_oxford.yaml",
    "/root/reference/oxford_results/randt_eval_10-12-32/odom/gt/01.txt",
)


def _require_gate_inputs():
    missing = [p for p in GATE_INPUTS if not os.path.exists(p)]
    if missing:
        pytest.skip(f"acceptance gate inputs not available: {missing}")


def test_acceptance_gate_green():
    _require_gate_inputs()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # undo the virtual-CPU pin
    env.pop("JAX_PLATFORM_NAME", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "acceptance_gate.py")],
        env=env, capture_output=True, text=True, timeout=2400, cwd=REPO,
    )
    assert r.returncode == 0, (
        f"acceptance gate RED:\n{r.stdout[-3000:]}\n{r.stderr[-2000:]}"
    )


def test_acceptance_gate_can_go_red():
    """The gate's self-test (CS threshold -> 0 kills every loop) must fail."""
    _require_gate_inputs()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORM_NAME", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "acceptance_gate.py"),
         "--selftest"],
        env=env, capture_output=True, text=True, timeout=2400, cwd=REPO,
    )
    assert r.returncode == 0, (
        f"gate self-test broken:\n{r.stdout[-3000:]}\n{r.stderr[-2000:]}"
    )
