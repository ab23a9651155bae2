"""Device-time breakdown of the front-end step on the GPU, from a trace.

Runs the offline driver's own ``lax.scan`` of ``frontend_step`` over frames
at the real Oxford geometry (``bench.build_frames``, ``oxford_config()``),
traces one warm call with ``jax.profiler`` and attributes every kernel to the
named scopes of the code that emitted it:

  * ``segment_moments`` — the scan-NDT moment reductions (scatter-add),
  * ``row_windows``     — the preprocessor's window gather,
  * ``lm_solve``        — the damped 36x36 window solve,
  * ``lm_iter``         — one LM iteration (linearize, solve, cost),
  * ``gnc_solve``       — the whole GNC/LM loop.

A kernel's scopes come from the optimized HLO: the ``op_name`` metadata of
the instruction the kernel runs (``hlo_op`` in the trace) and of everything
fused into it.  XLA replays runs of small kernels as one CUDA graph, which
the trace shows as a single ``command_buffer`` event; run with
``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` to see every kernel.

Phases (``--phases``, default all):
  * ``trace`` — the breakdown above;
  * ``ab``    — the LM window solve: the Pallas kernel against
    ``jnp.linalg.solve`` and ``cho_solve``, alone and inside the front end
    (steady ms/frame, rounds of all three in rotating order);
  * ``pgo``   — the 4077-node pose-graph solve on both of
    ``schur.optimize_auto``'s paths (dense and Schur).

    python scripts/profile_trace.py [--frames 40] [--out traces/frontend]

Prints one JSON line per result; the trace stays under ``--out``.
"""

import argparse
import glob
import json
import os
import re
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPES = ("segment_moments", "row_windows", "lm_solve", "lm_iter",
          "gnc_solve")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_CALLS = re.compile(
    r"(?:calls|to_apply|body|condition|branch_computations)="
    r"\{?([%\w.\-, ]+)\}?")
_OPNAME = re.compile(r'op_name="([^"]*)"')


def hlo_op_names(hlo_text: str) -> dict:
    """instruction name -> every ``op_name`` it runs, including those of the
    computations it calls (fusions, nested calls)."""
    own, calls, comp_instrs = {}, {}, defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            name = m.group(1)
            own[name] = set(_OPNAME.findall(line))
            calls[name] = [c.strip().lstrip("%") for grp in _CALLS.findall(line)
                           for c in grp.split(",") if c.strip()]
            if comp is not None:
                comp_instrs[comp].append(name)
            continue
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
        elif line.strip() == "}":
            comp = None

    memo = {}

    def names(instr, seen=()):
        if instr in memo:
            return memo[instr]
        out = set(own.get(instr, ()))
        for c in calls.get(instr, ()):
            if c in seen:
                continue
            for i in comp_instrs.get(c, ()):
                out |= names(i, seen + (c,))
        memo[instr] = out
        return out

    return {i: names(i) for i in own}


def scope_of(op_names) -> str | None:
    """Innermost of ``SCOPES`` that any op_name of the kernel sits in."""
    for s in SCOPES:
        if any(f"/{s}/" in n for n in op_names):
            return s
    return None


def kernel_events(profile, plane_prefix="/device:GPU", line_prefix="Stream"):
    """(hlo_op, start_ns, duration_ns) of every kernel on the device's
    streams."""
    out = []
    for plane in profile.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if not line.name.startswith(line_prefix):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" in stats:
                    out.append((stats["hlo_op"], ev.start_ns, ev.duration_ns))
    return out


def reduce_events(events, op_names: dict, frames: int) -> dict:
    """Per-scope device time per frame and share of busy time, busy/idle
    share of the traced window, and LM-iteration kernel counts."""
    if not events:
        raise RuntimeError("no kernel events in the trace")
    per_scope = defaultdict(float)
    per_kernel = defaultdict(float)
    lm_kernels, lm_events = set(), 0
    for op, _, dur in events:
        names = op_names.get(op, set())
        per_kernel[op] += dur
        inner = scope_of(names)
        for s in SCOPES:
            if any(f"/{s}/" in n for n in names):
                per_scope[s] += dur
        if inner in ("lm_iter", "lm_solve"):
            lm_kernels.add(op)
            lm_events += 1
    spans = sorted((s, s + d) for _, s, d in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    kernel_sum = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:20]
    return {
        "frames": frames,
        "busy_ms_per_frame": busy / 1e6 / frames,
        "window_ms_per_frame": window / 1e6 / frames,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "kernels_per_frame": len(events) / frames,
        "scope_ms_per_frame": {s: per_scope[s] / 1e6 / frames for s in SCOPES},
        "scope_share_of_kernel_time": {
            s: per_scope[s] / kernel_sum for s in SCOPES},
        "lm_kernels_per_iteration": len(lm_kernels),
        "lm_iterations_per_frame": (
            lm_events / len(lm_kernels) / frames if lm_kernels else 0.0),
        "top_kernels_ms_per_frame": [
            [op, t / 1e6 / frames, scope_of(op_names.get(op, ()))]
            for op, t in top],
    }


def profile_frontend(n_frames: int, out_dir: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.profiler import ProfileData

    import bench
    from randt_slam_tpu.pipeline import frontend as F

    cfg = bench.build_config()
    frames, _ = bench.build_frames(n_frames=n_frames)
    s2b = jnp.zeros(3)

    def body(c, fr):
        c2, out = F.frontend_step(cfg, c, fr, s2b)
        return c2, (out.odom_pose, out.sc_desc)

    scan_fn = jax.jit(lambda c, fs: jax.lax.scan(body, c, fs))
    carry0 = F.init_carry(cfg)
    compiled = scan_fn.lower(carry0, frames).compile()
    op_names = hlo_op_names(compiled.as_text())
    jax.block_until_ready(scan_fn(carry0, frames))        # warm
    t0 = time.perf_counter()
    jax.block_until_ready(scan_fn(carry0, frames))
    wall = time.perf_counter() - t0

    jax.profiler.start_trace(out_dir)
    jax.block_until_ready(scan_fn(carry0, frames))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    profile = ProfileData.from_file(path)
    with open(os.path.join(out_dir, "planes.json"), "w") as f:
        # the trace's layout, for reading it by hand
        json.dump({p.name: {ln.name: [[e.name, dict(e.stats)]
                                      for e in list(ln.events)[:3]]
                            for ln in p.lines} for p in profile.planes},
                  f, indent=1, default=str)
    res = reduce_events(kernel_events(profile), op_names, n_frames)
    res["untraced_wall_ms_per_frame"] = wall * 1e3 / n_frames
    return res


def ab_solve(n_frames: int, pairs: int = 5) -> dict:
    """The LM window solve: XLA's LU (``jnp.linalg.solve``), a Cholesky
    (``cho_solve``) and the Pallas kernel.  Per solve inside a device loop,
    then the front end's steady ms/frame with each, rounds of all variants
    in rotating order."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from randt_slam_tpu.ops.spd_solve import spd_solve
    from randt_slam_tpu.pipeline import frontend as F
    from randt_slam_tpu.registration import solver

    variants = {
        "lu": jnp.linalg.solve,
        "cholesky": lambda A, b: jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(A), b),
        "kernel": spd_solve,
    }
    rng = np.random.default_rng(0)
    J = rng.normal(0, 1, (120, 36))
    A = J.T @ J
    d = 1.0 / np.sqrt(np.diag(A))
    A = jnp.asarray(A * d[:, None] * d[None, :] + 1e-4 * np.eye(36),
                    jnp.float32)
    b = jnp.asarray(rng.normal(0, 1, 36), jnp.float32)
    reps = 1000

    def per_solve_us(fn):
        loop = jax.jit(lambda A, b: jax.lax.fori_loop(
            0, reps, lambda i, x: fn(A, b + 1e-9 * x), b))
        jax.block_until_ready(loop(A, b))
        t0 = time.perf_counter()
        jax.block_until_ready(loop(A, b))
        return (time.perf_counter() - t0) / reps * 1e6

    out = {"solve_us": {k: per_solve_us(f) for k, f in variants.items()}}

    cfg = bench.build_config()
    frames, _ = bench.build_frames(n_frames=n_frames)
    frames = jax.device_put(frames)
    carry0 = F.init_carry(cfg)
    s2b = jnp.zeros(3)

    def make_scan():
        # a fresh body per variant: lax.scan caches the jaxpr it traced
        # for a given function object
        def body(c, fr):
            c2, o = F.frontend_step(cfg, c, fr, s2b)
            return c2, (o.odom_pose, o.sc_desc)

        return jax.jit(lambda c, fs: jax.lax.scan(body, c, fs))

    shipped = solver.solve_damped
    exes = {}
    try:
        for name, fn in variants.items():
            solver.solve_damped = fn
            exes[name] = make_scan().lower(carry0, frames).compile()
    finally:
        solver.solve_damped = shipped
    names = list(exes)
    times = {k: [] for k in names}
    poses = {}
    for r in range(pairs):
        for name in names[r % len(names):] + names[:r % len(names)]:
            jax.block_until_ready(exes[name](carry0, frames))
            t0 = time.perf_counter()
            _, (p, _) = exes[name](carry0, frames)
            p = np.asarray(p)
            times[name].append((time.perf_counter() - t0) * 1e3 / n_frames)
            poses[name] = p
    out["frontend_ms_per_frame"] = times
    out["frontend_median_ms_per_frame"] = {
        k: float(np.median(v)) for k, v in times.items()}
    out["max_pose_diff_m_vs_lu"] = {
        k: float(np.max(np.abs(poses[k][:, :2] - poses["lu"][:, :2])))
        for k in names}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default=os.path.join("traces", "frontend"))
    ap.add_argument("--phases", default="trace,ab,pgo")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"profile_trace.py profiles a GPU; JAX found {dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    if "trace" in phases:
        res = profile_frontend(args.frames, args.out)
        print(json.dumps({"profile": "frontend_step", "device": device,
                          "xla_flags": os.environ.get("XLA_FLAGS", ""),
                          **res}), flush=True)
    if "ab" in phases:
        print(json.dumps({"profile": "spd_solve_ab", "device": device,
                          **ab_solve(args.frames)}), flush=True)
    if "pgo" not in phases:
        return

    import bench

    for solver, limit in (("schur", 2048), ("dense", 1 << 30)):
        ms, iters, used, _ = bench.bench_pgo_ms(dense_node_limit=limit)
        print(json.dumps({"profile": "pgo_4077_nodes", "device": device,
                          "route": used, "solve_ms": ms,
                          "iterations": iters}), flush=True)
        if used != solver:
            sys.exit(f"expected the {solver} route, got {used}")


if __name__ == "__main__":
    main()
