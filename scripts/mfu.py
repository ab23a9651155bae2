"""MFU / roofline analysis of the two hot kernels (BASELINE north star:
"NDT-registration and Schur-reduction kernels at speed-of-light per chip").

For each kernel this reports:
  * FLOPs and HBM bytes from XLA's own cost model of the compiled executable
    (``compiled.cost_analysis()`` — the numbers the compiler scheduled, not a
    hand count),
  * measured steady-state device time (many iterations, block_until_ready),
  * achieved FLOP/s and bytes/s against the device's published peaks ->
    utilization + limiter.

Peaks come from ``PEAKS``, keyed by ``jax.devices()[0].device_kind``; a
device that is not in the table is an error, never a default.  The process
runs float32 matmuls at ``highest`` precision (``randt_slam_tpu/__init__``),
which keeps them off the tensor cores, so f32 kernels are scored against
the plain float32 rate: the NDT moments and normal equations accumulate
9-decade-spread curvatures where reduced-precision inputs were observed to
corrupt the weak directions (see solver.py Jacobi scaling note).

Writes JSON to stdout.  Run on the GPU:
    python scripts/mfu.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks (no sparsity) at the full power limit.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,   # tensor cores, dense
        "f32_flops": 67e12,     # CUDA cores: the ceiling at `highest`
        "hbm_bytes": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; raises on a device not in the
    table rather than assuming a rate."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"add it to scripts/mfu.py PEAKS") from None


def cost_of(compiled):
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    return flops, byts


def report(name, flops, byts, dt_s, pk, f32=True, note=""):
    peak = pk["f32_flops"] if f32 else pk["bf16_flops"]
    ach_fl = flops / dt_s
    ach_bw = byts / dt_s
    mfu = ach_fl / peak
    hbm = ach_bw / pk["hbm_bytes"]
    limiter = "compute" if mfu >= hbm else "memory"
    ai = flops / max(byts, 1.0)
    crit = peak / pk["hbm_bytes"]
    return {
        "kernel": name,
        "device_time_ms": round(dt_s * 1e3, 3),
        "gflops": round(flops / 1e9, 2),
        "hbm_mb": round(byts / 1e6, 2),
        "arithmetic_intensity": round(ai, 2),
        "roofline_critical_intensity": round(crit, 1),
        "achieved_tflops": round(ach_fl / 1e12, 3),
        "achieved_gbps": round(ach_bw / 1e9, 1),
        "mfu_vs_f32_peak" if f32 else "mfu_vs_bf16_peak": round(mfu, 4),
        "hbm_utilization": round(hbm, 4),
        "limiter": limiter,
        "note": note,
    }


def timeit(fn, *args, n=30):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main(quiet=False, include_schur=True, bench_mod=None):
    import jax
    import jax.numpy as jnp

    if bench_mod is None:
        # standalone invocation: import the repo-root bench module.  When
        # called FROM bench.py the caller passes itself instead, so there is
        # no bench -> mfu -> bench import cycle.
        sys.path.insert(0, os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        import bench as bench_mod
    build_config = bench_mod.build_config
    build_frames = bench_mod.build_frames
    N_AZ, BIN_W = bench_mod.N_AZ, bench_mod.BIN_W
    MAX_RANGE = bench_mod.MAX_RANGE
    from randt_slam_tpu.pipeline import frontend as F
    from randt_slam_tpu.pipeline import slam

    pk = peaks(jax.devices()[0].device_kind)
    results = []
    cfg = build_config()
    frames, gt = build_frames()
    s2b = jnp.zeros(3)

    # ---- 1. full front-end step (the registration hot path) ---------------
    # One frontend_step = preprocess + scan-NDT build + window estimator
    # (residual/Jacobian/JtJ + LM/GNC loops) + submap insertion.
    step = jax.jit(lambda c, fr: F.frontend_step(cfg, c, fr, s2b))
    carry = F.init_carry(cfg)
    fr0 = jax.tree.map(lambda a: jnp.asarray(a[0]), frames)
    lowered = step.lower(carry, fr0)
    compiled = lowered.compile()
    fl_step, by_step = cost_of(compiled)
    # warm the carry so the window/submap are populated (realistic occupancy)
    for i in range(12):
        fr = jax.tree.map(lambda a: jnp.asarray(a[i]), frames)
        carry, _ = step(carry, fr)
    jax.block_until_ready(carry.states)
    frN = jax.tree.map(lambda a: jnp.asarray(a[12]), frames)
    dt_call = timeit(lambda c: step(c, frN)[0], carry, n=30)

    # Pipeline-context per-frame time: one lax.scan over 40 device-resident
    # frames in a single executable — this is how the offline driver actually
    # runs the step, and it excludes the per-call dispatch overhead that
    # inflates the single-call number above.
    def _body(c, fr):
        c2, out = F.frontend_step(cfg, c, fr, s2b)
        # return the descriptor too — the offline driver materializes it
        # every frame, and returning only the pose would let XLA dead-code
        # the ScanContext build out of this measurement
        return c2, (out.odom_pose, out.sc_desc)

    scan_fn = jax.jit(lambda c, fs: jax.lax.scan(_body, c, fs))
    d40 = jax.tree.map(lambda a: jnp.asarray(a[:40]), frames)
    c0 = F.init_carry(cfg)
    _, poses = scan_fn(c0, d40)
    jax.block_until_ready(poses)
    t0 = time.perf_counter()
    for _ in range(5):
        _, poses = scan_fn(c0, d40)
    jax.block_until_ready(poses)
    dt = (time.perf_counter() - t0) / 5 / 40
    r = report(
        "frontend_step (preprocess + NDT build + window GNC-LM)",
        fl_step, by_step, dt, pk, f32=True,
        note="per-frame time inside a 40-frame lax.scan (the pipeline "
             "shape); LM/GNC trip counts are data-dependent (while_loops) "
             "so XLA flops are per-iteration lower bounds",
    )
    r["single_call_ms_incl_dispatch"] = round(dt_call * 1e3, 3)
    r["cost_model_caveat"] = (
        "XLA bytes-accessed counts BOTH cond branches and exactly one "
        "while-loop trip, so hbm_utilization is a bound, not a measurement; "
        "scripts/profile_trace.py has the measured per-op breakdown")
    results.append(r)

    # ---- 2. segment-moments reduction at front-end shapes -----------------
    import importlib
    SM = importlib.import_module("randt_slam_tpu.ops.segment_moments")

    P = N_AZ * int(MAX_RANGE / BIN_W) // 8  # points kept by the peak filter
    P = 1 << int(np.ceil(np.log2(P)))
    CH = 10
    S = 1024
    rng = np.random.default_rng(0)
    vals = jnp.asarray(rng.random((P, CH)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, S, P), jnp.int32)
    sm = jax.jit(lambda v, i: SM.segment_moments(v, i, S))
    fl_sm, by_sm = cost_of(sm.lower(vals, ids).compile())
    dt_sm = timeit(sm, vals, ids, n=100)
    results.append(report(
        f"segment_moments segment_sum (P={P}, S={S}, CH={CH})",
        fl_sm, by_sm, dt_sm, pk, f32=True,
        note="jax.ops.segment_sum (scatter-add) as XLA compiles it",
    ))

    # ---- 3. Schur-reduction iteration at the real sequence size -----------
    if not include_schur:       # bench.py already measures this itself
        if not quiet:
            print(json.dumps({"mfu": results}, indent=2))
        return results
    _, _, solver, it_ms = bench_mod.bench_pgo_ms()
    # cost model of the iteration kernel: reuse the jitted iteration from the
    # benchmark helper (its flops live inside schur's cached kernels; measure
    # achieved bytes via the graph arrays as a lower bound)
    results.append({
        "kernel": f"schur iteration (4077 nodes, solver={solver})",
        "device_time_ms": round(it_ms, 2),
        "note": "per-GN-iteration device time; dominated by (3S x 3S) "
                "separator solve + per-submap block solves",
    })

    if not quiet:
        print(json.dumps({"mfu": results}, indent=2))
    return results


if __name__ == "__main__":
    main()
