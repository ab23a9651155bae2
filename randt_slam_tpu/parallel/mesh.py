"""Device-mesh helpers for multi-chip scaling.

The reference is a single-process shared-memory system (SURVEY.md §2.2);
this build scales along these axes instead:

  * ``data``  — independent sequences (rosbags) processed in parallel, one
    front-end state per shard (BASELINE configs 4-5),
  * ``graph`` — pose-graph/loop-closure work sharded by edge/candidate blocks,
    reduced with psum collectives (see ``graph/schur.py``).
"""

from __future__ import annotations

import jax
import numpy as np

def shard_map(f, **kw):
    """``jax.shard_map`` with the varying-manual-axes check disabled: the
    front-end solver's while-loops initialize carries (damping, convergence
    flags) from unvarying constants that become shard-varying after one
    iteration, which the strict checker rejects."""
    return jax.shard_map(f, check_vma=False, **kw)


P = jax.sharding.PartitionSpec


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Multi-host runtime init (``jax.distributed``).

    Reads ``RANDT_COORDINATOR`` / ``RANDT_NUM_PROCESSES`` / ``RANDT_PROCESS_ID``
    when arguments are omitted (the standard launcher-env pattern); a no-op
    for single-process runs so all entry points can call it unconditionally.
    After a successful init, ``data_mesh()`` spans every chip of every host
    and the sharded paths' psum/all-gather collectives span them with no
    further code changes.
    Returns True iff a multi-process runtime was initialized.
    """
    import os

    coord = coordinator_address or os.environ.get("RANDT_COORDINATOR")
    n = num_processes if num_processes is not None else int(
        os.environ.get("RANDT_NUM_PROCESSES", "1"))
    pid = process_id if process_id is not None else int(
        os.environ.get("RANDT_PROCESS_ID", "0"))
    if n <= 1 or coord is None:
        return False
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=n, process_id=pid)
    return True


def data_mesh(n_devices: int | None = None, devices=None) -> jax.sharding.Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), ("data",))


def batch_spec(pytree, axis_name="data"):
    """PartitionSpec sharding the leading (batch) axis of every leaf."""
    return jax.tree.map(lambda _: P(axis_name), pytree)
