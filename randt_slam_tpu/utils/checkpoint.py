"""Checkpoint / resume for long runs.

The reference has no persistence at all (SURVEY.md §5: state lives in RAM,
results exported only at shutdown).  Long pod runs need resumable state, so
the front-end carry (a pytree of arrays) plus the host-side node/edge tables
snapshot to a single ``.npz``.
"""

from __future__ import annotations

import json

import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save_carry(path: str, carry, extra: dict | None = None):
    """Snapshot a FrontendCarry (or any NamedTuple pytree) to .npz."""
    flat = _flatten(carry)
    if extra:
        for k, v in extra.items():
            flat[f"__extra__/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


# Fields added AFTER checkpoints already existed in the wild: only these may
# fall back to the template value when missing from a snapshot.  Anything else
# missing means a truncated/mismatched file and must raise, not silently
# resume from partly-default state.  The derived-field caches are
# safe to default because they are rebuilt at the next keyframe exit.
MIGRATED_FIELDS = frozenset({
    "submap_fmean", "submap_fcov", "submap_fvalid",
    "prev_fmean", "prev_fcov", "prev_fvalid",
})


def load_carry(path: str, template):
    """Rebuild a carry pytree with the structure of ``template`` from .npz.

    Fields in :data:`MIGRATED_FIELDS` missing from the snapshot keep the
    TEMPLATE's value — carries saved before such a field was added stay
    loadable.  Any other missing field raises ``KeyError``.
    """
    import jax.numpy as jnp

    data = np.load(path)

    def rebuild(node, prefix=""):
        if hasattr(node, "_asdict") and hasattr(node, "_replace"):
            kw = {
                k: rebuild(v, f"{prefix}{k}/")
                for k, v in node._asdict().items()
            }
            return type(node)(**kw)
        key = prefix.rstrip("/")
        if key not in data.files:
            if key in MIGRATED_FIELDS:
                return node  # pre-migration checkpoint without this field
            raise KeyError(
                f"checkpoint {path!r} is missing field {key!r} (not a known "
                f"migrated field) — refusing to resume from a truncated or "
                f"mismatched snapshot")
        return jnp.asarray(data[key])

    return rebuild(template)


def load_extra(path: str) -> dict:
    data = np.load(path)
    return {
        k.split("/", 1)[1]: data[k]
        for k in data.files
        if k.startswith("__extra__/")
    }
