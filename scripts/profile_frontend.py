"""Time the front-end stages in isolation on the GPU.

Stages: preprocess+scan-NDT, derive_grid_fields (per-frame fixed-map field
derivation), association, and the GNC/LM solve — to target Pallas work.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np

from bench import build_config
from randt_slam_tpu.io import synthetic
from randt_slam_tpu.pipeline import frontend as F
from randt_slam_tpu.pipeline import slam
from randt_slam_tpu.ndt import grid as G
from randt_slam_tpu.registration import matcher


def timeit(name, fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:35s} {dt*1e3:8.3f} ms")
    return out


def main():
    cfg = build_config()
    T = 12
    seq = synthetic.generate(seed=0, n_frames=T, n_azimuths=400, n_bins=512,
                             max_range=100.0, speed=4.0, dt=0.25, n_walls=120)
    frames = slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                     seq.stamps)
    s2b = jnp.zeros(3)

    # advance carry a few frames so the submap is populated
    step = jax.jit(lambda c, fr: F.frontend_step(cfg, c, fr, s2b))
    carry = F.init_carry(cfg)
    for i in range(T):
        fr = jax.tree.map(lambda a: a[i], frames)
        carry, _ = step(carry, fr)
    jax.block_until_ready(carry.submap.stats.n)
    fr = jax.tree.map(lambda a: a[T - 1], frames)

    # 1. full step
    timeit("full frontend_step", step, carry, fr)

    # 2. preprocess + scan NDT
    bsc = jax.jit(lambda f: F.build_scan_cells(cfg, f, s2b)[0])
    scan = timeit("build_scan_cells", bsc, fr)

    # 3. derive grid fields (x2 maps per frame)
    cell_cfg = cfg.ndt_map.cell
    dgf = jax.jit(lambda g: G.derive_sparse_fields(g, cfg.ndt_map.min_points_per_cell, cell_cfg))
    f1 = timeit("derive_sparse_fields (1 map)", dgf, carry.submap)

    # 4. association: window_neighbors vmapped over W slots x F maps
    geom = G.GridGeom.from_config(cfg.ndt_map)
    W = cfg.matcher.smoothing_steps
    K = cfg.matcher.n_results_nn_lookup
    radius = cfg.ndt_map.nn_window_radius
    poses = carry.states[-W:, :3]

    fidx = carry.submap.index

    def assoc_fn(sm, sc, sv, fm, fc, fv):
        q_mu, q_cov = matcher.transform_mean_cov(poses, sm, sc)
        def one(qm, qc, qv):
            return G.window_neighbors_sparse(geom, fidx, fm, fc, fv, qm, qc, qv,
                                             K, radius,
                                             use_distribution_metric=cfg.matcher.lookup_distribution)
        return jax.vmap(one)(q_mu, q_cov, sv)

    af = jax.jit(assoc_fn)
    timeit("association (W slots, 1 map)", af, carry.scan_mean, carry.scan_cov,
           carry.scan_valid, f1[0], f1[1], f1[2])

    # 5. full estimate_window (assoc + GNC/LM)
    TB = cfg.capacity.traj_buffer
    f2 = dgf(carry.prev_submap)
    fixed = matcher.FixedMaps(
        index=(carry.submap.index, carry.prev_submap.index),
        mean=jnp.stack([f1[0], f2[0]]), cov=jnp.stack([f1[1], f2[1]]),
        valid=jnp.stack([f1[2], f2[2]]),
        use=jnp.asarray([True, False]))
    ew = jax.jit(lambda st, sm, sc, sv: matcher.estimate_window(
        cfg, st[TB - W - 1:], carry.stamps[TB - W - 1:],
        jnp.ones(W + 1, bool), carry.imu_meas[TB - W:],
        matcher.ScanWindow(mean=sm, cov=sc, valid=sv), fixed,
        st[-1, :3]))
    timeit("estimate_window (assoc+solve)", ew, carry.states, carry.scan_mean,
           carry.scan_cov, carry.scan_valid)


if __name__ == "__main__":
    main()
