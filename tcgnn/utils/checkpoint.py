"""Parameter checkpoint save/resume.

The reference never saves models (SURVEY.md §5: "checkpoint / resume:
none"); this is additive scope for real training runs.  Uses
orbax-checkpoint when importable, with a plain ``np.savez`` pytree fallback
so the feature has no hard dependency.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def _flatten(params) -> dict:
    leaves, treedef = jax.tree.flatten(params)
    return {
        "leaves": [np.asarray(leaf) for leaf in leaves],
        "treedef": treedef,
    }


def save(path: str, params: Any, step: int = 0) -> str:
    """Save a params pytree; returns the written path."""
    try:
        import orbax.checkpoint as ocp

        path = os.path.abspath(path)
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, jax.tree.map(np.asarray, params), force=True)
        ckptr.wait_until_finished()
        return path
    except Exception:
        flat = _flatten(params)
        path = path if path.endswith(".npz") else path + ".npz"
        np.savez(
            path,
            step=step,
            **{f"leaf_{i}": leaf for i, leaf in enumerate(flat["leaves"])},
        )
        return path


def save_state(
    ckpt_dir: str, params: Any, opt_state: Any, epoch: int,
    key: Any = None, keep: int = 3,
) -> str:
    """Failure-safe training-state checkpoint (params + optimizer + PRNG
    key + epoch).

    Writes ``state_<epoch>.npz`` via a temp file + atomic ``os.replace``
    and then updates the ``LATEST`` pointer, so a crash mid-write never
    corrupts the resumable state (the previous checkpoint stays intact) —
    the recovery contract behind the trainer's ``--checkpoint_every`` /
    ``--resume`` flags.  The ``key`` makes the resumed dropout stream
    continue instead of replaying from the seed.  Only the newest
    ``keep`` snapshots are retained (older ones are pruned after the
    LATEST pointer moves).
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = jax.tree.leaves({"p": params, "o": opt_state})
    path = os.path.join(ckpt_dir, f"state_{epoch:08d}.npz")
    # np.savez appends ".npz" when missing — keep the temp name suffixed.
    tmp = os.path.join(ckpt_dir, f".tmp_state_{epoch:08d}.npz")
    extra = {} if key is None else {"prng_key": np.asarray(key)}
    np.savez(
        tmp, epoch=epoch,
        **extra,
        **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)},
    )
    os.replace(tmp, path)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(path))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    if keep is not None:
        snaps = sorted(
            f for f in os.listdir(ckpt_dir)
            if f.startswith("state_") and f.endswith(".npz")
        )
        for old in snaps[:-keep]:
            try:
                os.remove(os.path.join(ckpt_dir, old))
            except OSError:
                pass
    return path


def restore_state(ckpt_dir: str, params_like: Any, opt_state_like: Any):
    """Restore the newest training state.

    Returns ``(params, opt_state, epoch, key)`` (``key`` is None when the
    snapshot carries none), or None when the directory holds no
    checkpoint.
    """
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        path = os.path.join(ckpt_dir, f.read().strip())
    like = {"p": params_like, "o": opt_state_like}
    leaves, treedef = jax.tree.flatten(like)
    with np.load(path) as data:
        epoch = int(data["epoch"])
        key = data["prng_key"] if "prng_key" in data else None
        loaded = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for want, got in zip(leaves, loaded):
        if np.shape(want) != got.shape:
            raise ValueError(
                f"checkpoint shape mismatch: {got.shape} vs {np.shape(want)}"
            )
        # Dtype must match too: resuming a run launched with a different
        # --dtype (same-shaped leaves) would otherwise silently continue
        # at the checkpoint's dtype.  Read the dtype ATTRIBUTE — an
        # np.asarray on a device leaf forces a device->host fetch per
        # parameter.
        want_dt = getattr(want, "dtype", None) or np.asarray(want).dtype
        if want_dt != got.dtype:
            raise ValueError(
                f"checkpoint dtype mismatch: {got.dtype} vs {want_dt} "
                "(was this run launched with a different --dtype?)"
            )
    state = jax.tree.unflatten(treedef, loaded)
    return state["p"], state["o"], epoch, key


def restore(path: str, like: Any) -> Any:
    """Restore a params pytree with the structure of ``like``."""
    if os.path.isdir(path):
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        return ckptr.restore(path, jax.tree.map(np.asarray, like))
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        leaves, treedef = jax.tree.flatten(like)
        loaded = [data[f"leaf_{i}"] for i in range(len(leaves))]
        for want, got in zip(leaves, loaded):
            if np.shape(want) != got.shape:
                raise ValueError(
                    f"checkpoint shape mismatch: {got.shape} vs {np.shape(want)}"
                )
        return jax.tree.unflatten(treedef, loaded)
