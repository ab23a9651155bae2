"""Multi-process runtime smoke test (``jax.distributed`` over loopback).

The reference is single-process (SURVEY.md §2.2); this build's multi-host
story is ``parallel/mesh.py::init_distributed`` + collectives over the global
mesh.  This cannot be faked with the in-process 8-virtual-device mesh — it
needs real separate processes talking through the distributed runtime, which
is exactly what the per-host processes of a multi-host run do (BASELINE
config 5).

Here: two OS processes, each one CPU device, coordinated over 127.0.0.1.
Verifies init_distributed env-var wiring, the global mesh spanning both
processes, a psum riding the cross-process collective, and a sharded
pose-graph assembly (optimize_distributed) agreeing with the single-process
dense solve.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.environ["REPO"])
    import numpy as np
    import jax
    import jax.numpy as jnp
    from randt_slam_tpu.parallel.mesh import (
        P, data_mesh, init_distributed, shard_map)

    assert init_distributed(), "env-var wiring failed"
    assert jax.process_count() == 2
    mesh = data_mesh()
    n = jax.device_count()
    assert n == 2, f"expected 2 global devices, got {n}"

    # cross-process psum: shard i carries value (i+1); sum = 3
    def f(x):
        return jax.lax.psum(jnp.sum(x), "data")

    local = np.full((1,), 1.0 + jax.process_index(), np.float32)
    from jax.sharding import NamedSharding
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), local, global_shape=(2,))
    out = jax.jit(shard_map(f, mesh=mesh, in_specs=P("data"),
                            out_specs=P()))(arr)
    np.testing.assert_allclose(np.asarray(out), 3.0)

    # sharded pose-graph solve across the two processes vs dense reference
    from randt_slam_tpu.config import GlobalFuserConfig
    from randt_slam_tpu.graph import pose_graph as PG
    from randt_slam_tpu.graph import schur

    rng = np.random.default_rng(0)
    N = 24
    t = np.linspace(0, 2 * np.pi, N, endpoint=False)
    gt = np.stack([10 * np.cos(t), 10 * np.sin(t), t + np.pi / 2], 1)
    noisy = gt + np.concatenate(
        [np.zeros((1, 3)), np.cumsum(rng.normal(0, 0.02, (N - 1, 3)), 0)])

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b - a
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))])

    eb = np.arange(N - 1); ee = eb + 1
    trans = np.stack([rel(gt[i], gt[i + 1]) for i in range(N - 1)])
    sqrtI = np.tile(np.diag([10.0, 10.0, 20.0]), (N - 1, 1, 1))
    g = PG.PoseGraph(
        poses=jnp.asarray(noisy, jnp.float32),
        id_begin=jnp.asarray(eb, jnp.int32), id_end=jnp.asarray(ee, jnp.int32),
        trans=jnp.asarray(trans, jnp.float32),
        sqrt_information=jnp.asarray(sqrtI, jnp.float32),
        valid=jnp.ones(N - 1, bool))
    cfg = GlobalFuserConfig()
    sharded, _ = schur.optimize_distributed(g, cfg, mesh)
    dense, _ = PG.optimize(g, cfg)
    err = np.abs(np.asarray(sharded) - np.asarray(dense))
    assert err.max() < 5e-3, err.max()
    print(f"DISTRIBUTED_OK process={jax.process_index()}")
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_smoke(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            REPO=repo,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
            RANDT_COORDINATOR=f"127.0.0.1:{port}",
            RANDT_NUM_PROCESSES="2",
            RANDT_PROCESS_ID=str(pid),
        )
        # clean PYTHONPATH: the children run the plain multi-process CPU
        # runtime, with nothing on the path that could change backends
        env["PYTHONPATH"] = ""
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "DISTRIBUTED_OK" in out
