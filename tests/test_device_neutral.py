"""What keeps the program backend-neutral and its measurements honest:
peak-rate lookup, compile-cache placement, the GPU smoke test's refusal to
run elsewhere, the trace reduction, and no accelerator-specific kernels."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


def test_mfu_peaks_for_h100_sxm():
    import mfu

    pk = mfu.peaks("NVIDIA H100 80GB HBM3")
    assert pk == {"bf16_flops": 989e12, "f32_flops": 67e12,
                  "hbm_bytes": 3.35e12}


def test_mfu_peaks_unknown_device_raises():
    import mfu

    with pytest.raises(KeyError, match="no published peaks"):
        mfu.peaks("cpu")


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "RANDT_NO_COMPILE_CACHE",
                        "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    extra = {}
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        extra["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c",
         "import randt_slam_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=_child_env(**extra), capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


def test_chip_smoke_refuses_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_child_env(), capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_trace_reduction_attributes_scopes():
    import profile_trace as PT

    hlo = """
HloModule jit_step

%fused_scatter (p0: f32[8]) -> f32[4] {
  %p0 = f32[8]{0} parameter(0)
  ROOT %scatter.1 = f32[4]{0} scatter(%p0), metadata={op_name="jit(step)/while/body/segment_moments/scatter-add"}
}

%fused_solve (p0: f32[36,36]) -> f32[36] {
  %p0 = f32[36,36]{1,0} parameter(0)
  ROOT %lu.2 = f32[36]{0} custom-call(%p0), metadata={op_name="jit(step)/while/body/gnc_solve/while/body/lm_iter/lm_solve/lu"}
}

ENTRY %main (a: f32[8]) -> f32[4] {
  %a = f32[8]{0} parameter(0)
  %scatter_fusion = f32[4]{0} fusion(%a), kind=kInput, calls=%fused_scatter
  %solve_fusion = f32[36]{0} fusion(%a), kind=kCustom, calls=%fused_solve
  ROOT %add.3 = f32[4]{0} add(%scatter_fusion, %scatter_fusion), metadata={op_name="jit(step)/add"}
}
"""
    names = PT.hlo_op_names(hlo)
    assert PT.scope_of(names["scatter_fusion"]) == "segment_moments"
    assert PT.scope_of(names["solve_fusion"]) == "lm_solve"
    assert PT.scope_of(names["add.3"]) is None
    # two frames; kernels overlap in [10, 15) and leave [40, 50) idle
    events = [("scatter_fusion", 0, 15), ("solve_fusion", 10, 30),
              ("add.3", 50, 10), ("solve_fusion", 60, 40)]
    r = PT.reduce_events(events, names, frames=2)
    assert r["busy_ms_per_frame"] == pytest.approx(90 / 1e6 / 2)
    assert r["idle_share"] == pytest.approx(0.1)
    assert r["scope_ms_per_frame"]["lm_solve"] == pytest.approx(70 / 1e6 / 2)
    assert r["scope_ms_per_frame"]["gnc_solve"] == pytest.approx(70 / 1e6 / 2)
    assert r["scope_ms_per_frame"]["segment_moments"] == pytest.approx(
        15 / 1e6 / 2)
    assert r["lm_kernels_per_iteration"] == 1
    assert r["lm_iterations_per_frame"] == pytest.approx(1.0)


def _program_files():
    roots = [os.path.join(REPO, "randt_slam_tpu"), os.path.join(REPO, "scripts")]
    files = [os.path.join(REPO, f) for f in
             ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for root in roots:
        for d, _, fs in os.walk(root):
            files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return files


@pytest.mark.parametrize("pattern", [
    r"pallas\s+import\s+tpu|pallas\.tpu|pltpu",         # chip-specific kernels
    r"""==\s*["']tpu["']|["']tpu["']\s*==""",            # backend branches
    r"use_pallas_",                                     # their options
])
def test_no_accelerator_specific_code(pattern):
    hits = []
    for path in _program_files():
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert not hits, hits
