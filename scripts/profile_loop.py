"""Loop-phase micro-profile at Oxford shapes.

Times the pieces of one refine+gate chunk (loops/detector.py step 3-4) in
isolation on the live backend: association, GNC refinement, scan self-term,
CS-divergence gate — so optimization effort lands where the 55 s actually
goes.  Shapes mirror the acceptance runs: C=512 scan cells, S=4096 submap
cells, CCH=64 candidates per chunk.
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(name, fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:44s} {dt*1e3:9.2f} ms", flush=True)
    return out


def fake_cells(rng, n, occupancy, extent):
    """Valid-masked cell table with plausible means/covs."""
    mean = jnp.asarray(np.concatenate([
        rng.uniform(-extent, extent, (n, 2)),
        rng.uniform(0.2, 1.0, (n, 1))], axis=1), jnp.float32)
    A = rng.normal(0, 0.2, (n, 3, 3))
    cov = jnp.asarray(A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(3), jnp.float32)
    valid = jnp.asarray(rng.random(n) < occupancy)
    return mean, cov, valid


def main():
    from functools import partial

    from randt_slam_tpu.config import from_reference_yaml
    from randt_slam_tpu.ndt import divergence as D
    from randt_slam_tpu.ndt import grid as G
    from randt_slam_tpu.registration import matcher

    cfg = from_reference_yaml(
        "/root/reference/ros/ndt_radar_slam/config/parameters_oxford.yaml")
    print(f"backend: {jax.devices()[0].platform}", flush=True)
    rng = np.random.default_rng(0)
    CCH = 64
    C = cfg.capacity.max_scan_cells
    S = cfg.capacity.max_submap_cells
    print(f"CCH={CCH} C={C} S={S} "
          f"csm_prealign={cfg.local_fuser.csm_prealign_loops}")

    def stack_cells(n, occ, ext, seed0):
        ms, cs, vs = [], [], []
        for i in range(CCH):
            m, c, v = fake_cells(np.random.default_rng(seed0 + i), n, occ, ext)
            ms.append(m); cs.append(c); vs.append(v)
        return jnp.stack(ms), jnp.stack(cs), jnp.stack(vs)

    f_mean, f_cov, f_valid = stack_cells(S, 0.5, 80.0, 0)
    m_mean, m_cov, m_valid = stack_cells(C, 0.7, 60.0, 100)
    init = jnp.asarray(rng.normal(0, 1.0, (CCH, 3)), jnp.float32)

    K = cfg.matcher.n_results_nn_lookup
    cutoff = (cfg.ndt_map.nn_window_radius + 0.5) * cfg.ndt_map.resolution
    use_int = bool(cfg.local_fuser.use_intensity_in_loop_closure)
    lookup_dist = bool(cfg.matcher.lookup_distribution) and use_int

    # 1. association alone (the (C, S) all-pairs inside estimate_loop)
    def assoc_one(pose, fm, fc, fv, mm, mc, mv):
        qm, qc = matcher.transform_mean_cov(pose, mm, mc)
        nb = G.allpairs_neighbors(fm, fc, fv, qm, qc, mv, K, cutoff,
                                  use_distribution_metric=lookup_dist)
        return nb.mean
    timeit("allpairs association (vmapped chunk)",
           jax.jit(jax.vmap(assoc_one)),
           init, f_mean, f_cov, f_valid, m_mean, m_cov, m_valid)

    # 2. full refine (association + GNC x LM)
    refine = jax.jit(jax.vmap(partial(matcher.estimate_loop, cfg)))
    est = timeit("estimate_loop refine (assoc + GNC/LM)", refine,
                 init, f_mean, f_cov, f_valid, m_mean, m_cov, m_valid)

    # 3. scan self-term (C x C)
    m_self = timeit("m_self (C^2 self term)",
                    jax.jit(jax.vmap(D.self_term)), m_mean, m_cov, m_valid)
    f_self = timeit("f_self (S^2 self term)",
                    jax.jit(jax.vmap(D.self_term)), f_mean, f_cov, f_valid)

    # 4. CS gate (S x C cross term)
    def gate(pose, fm, fc, fv, mm, mc, mv, fs, ms):
        mm2, mc2 = matcher.transform_mean_cov(pose, mm, mc)
        return D.cs_divergence(fm, fc, fv, mm2, mc2, mv, f_self=fs, m_self=ms)
    timeit("cs gate (S x C cross)", jax.jit(jax.vmap(gate)),
           est.pose, f_mean, f_cov, f_valid, m_mean, m_cov, m_valid,
           f_self, m_self)

    # 5. CSM pre-align if the config ships it
    if cfg.local_fuser.csm_prealign_loops:
        presearch = jax.jit(jax.vmap(partial(
            matcher.global_grid_search, cfg, use_intensity=use_int)))
        timeit("csm prealign (global_grid_search)", presearch,
               init, f_mean, f_cov, f_valid, m_mean, m_cov, m_valid)


if __name__ == "__main__":
    main()
