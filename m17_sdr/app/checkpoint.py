"""Checkpoint / resume for streaming modem state (SURVEY.md section 5.4).

The reference has no checkpointing -- its nearest equivalent is the
config.txt startup profile plus rebuilding receiver state from the air
in ~6 frames (mmi.cpp:225-238, m17_rx_parse.cpp:71-85).  Here ALL
per-channel carry state is one pytree (RxSessionState + the rate
converter's FIR tail), so a checkpoint is an exact suspension point: a
session split at any block boundary and resumed from the file is
bit-identical to the uninterrupted run (tests/test_checkpoint.py).

Format: npz with path-derived keys ("rx/receiver/index", ...) plus a
format tag, so field reordering in the NamedTuples cannot silently
scramble a restore.
"""

from __future__ import annotations

import numpy as np

FORMAT = "m17-sdr-ckpt-v1"


def _flatten_with_paths(tree):
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in leaves:
        key = "/".join(
            str(getattr(p, "name", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


def save_state(path: str, tree, extra: dict | None = None) -> None:
    """Persist any modem-state pytree (e.g. StreamChunkState,
    RxSessionState, a TX ModState) to an npz file."""
    data = _flatten_with_paths(tree)
    data["__format__"] = np.asarray(FORMAT)
    for k, v in (extra or {}).items():
        data[f"extra/{k}"] = np.asarray(v)
    np.savez(path, **data)


def load_state(path: str, template):
    """Restore a pytree saved by save_state into `template`'s structure
    (use e.g. RxSessionState.init(batch) as the template)."""
    import jax
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        if str(z["__format__"]) != FORMAT:
            raise ValueError(f"unknown checkpoint format in {path}")
        stored = {k: z[k] for k in z.files
                  if k != "__format__" and not k.startswith("extra/")}
        extra = {k[6:]: z[k] for k in z.files if k.startswith("extra/")}

    flat = _flatten_with_paths(template)
    missing = set(flat) - set(stored)
    surplus = set(stored) - set(flat)
    if missing or surplus:
        raise ValueError(
            f"checkpoint field mismatch: missing={sorted(missing)} "
            f"surplus={sorted(surplus)}")

    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, leaf in paths_leaves:
        key = "/".join(
            str(getattr(p, "name", getattr(p, "idx", p))) for p in path)
        arr = stored[key]
        if arr.shape != np.shape(leaf):
            raise ValueError(
                f"checkpoint shape mismatch at {key}: "
                f"{arr.shape} vs {np.shape(leaf)}")
        leaves.append(jnp.asarray(arr, dtype=np.asarray(leaf).dtype))
    restored = jax.tree_util.tree_unflatten(treedef, leaves)
    return (restored, extra) if extra else (restored, {})
