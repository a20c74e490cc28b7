"""Checkpoint / resume for particle filter states (SURVEY.md §5).

The reference has no serialization (state is an in-memory Julia struct);
on preemptible accelerator machines checkpointing is table stakes. Because a
:class:`~..smc.state.ParticleFilterState` is a pytree of arrays, orbax
makes this nearly free: we save the flattened leaves plus the treedef-
defining model identity, and restore onto the running model's structure.

Backend selection: orbax when importable, else a portable ``.npz`` of the
flattened leaves. The fallback triggers ONLY on orbax being absent — a real
orbax failure (permissions, partial write, corrupt checkpoint) propagates
to the caller instead of being silently masked by a divergent npz copy.

Checkpoints carry a format-version marker plus the saved leaf count and
shapes; :func:`restore_state` validates both against ``like`` and raises a
clear incompatibility error instead of silently loading leaves into
shifted slots.
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import numpy as np

__all__ = ["save_state", "restore_state"]

#: bump when the on-disk layout changes incompatibly. v2 added the
#: metadata record (v1 checkpoints — round ≤2, no metadata — still load,
#: with shape validation only).
FORMAT_VERSION = 2


def _orbax_checkpointer():
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        return None
    return ocp.StandardCheckpointer()


def _meta(data) -> str:
    return json.dumps({
        "format_version": FORMAT_VERSION,
        "n_leaves": len(data),
        "shapes": [list(d.shape) for d in data],
        "dtypes": [str(d.dtype) for d in data],
    })


def _check_meta(meta: dict | None, expected) -> None:
    """Validate a loaded metadata record against the ``like``-derived leaf
    list; ``None`` (a pre-versioning checkpoint) skips count validation."""
    if meta is None:
        return
    v = meta.get("format_version")
    if v is None or v > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format_version {v!r} is newer than this library's "
            f"{FORMAT_VERSION}; upgrade genparticlefilters_tpu to restore it")
    if meta.get("n_leaves") != len(expected):
        raise ValueError(
            f"checkpoint is incompatible with `like`: it holds "
            f"{meta.get('n_leaves')} data leaves but the provided structure "
            f"expects {len(expected)} (different model, horizon, or library "
            "version)")
    for i, (shp, exp) in enumerate(zip(meta.get("shapes", []), expected)):
        if tuple(shp) != tuple(np.shape(exp)):
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(shp)} but `like` "
                f"expects {tuple(np.shape(exp))} (different particle count, "
                "horizon, or model)")


def save_state(path: str, state) -> None:
    """Save a ParticleFilterState (or any pytree of arrays) to ``path``.

    Uses orbax when available, else a portable .npz of the flattened leaves.
    Orbax I/O errors propagate (no silent fallback). Zero-size leaves
    (e.g. the slimmed step-trace score placeholders) carry no data and are
    skipped — :func:`restore_state` reconstructs them from ``like``. A
    format-version + leaf-count/shape record is written alongside the data
    and validated on restore."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    data = [np.asarray(l) for l in leaves if np.asarray(l).size > 0]
    ckptr = _orbax_checkpointer()
    if ckptr is not None:
        p = os.path.abspath(path)
        ckptr.save(p, data, force=True)
        ckptr.wait_until_finished()
        with open(p + ".meta.json", "w") as f:
            f.write(_meta(data))
        return
    np.savez(path if path.endswith(".npz") else path + ".npz",
             __meta__=np.frombuffer(_meta(data).encode(), dtype=np.uint8),
             **{f"leaf_{i}": l for i, l in enumerate(data)})


def restore_state(path: str, like) -> Any:
    """Restore a state saved by :func:`save_state`; ``like`` provides the
    pytree structure (e.g. a freshly initialized state of the same model
    and particle count). Orbax I/O errors propagate; the npz path is only
    consulted when orbax is absent or the orbax checkpoint directory does
    not exist (a save made by the npz fallback). Raises ``ValueError`` when
    the checkpoint's version/leaf-count/shapes do not match ``like``."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    nonzero = [l for l in leaves if np.asarray(l).size > 0]
    ckptr = _orbax_checkpointer()
    if ckptr is not None and os.path.isdir(os.path.abspath(path)):
        p = os.path.abspath(path)
        meta = None
        if os.path.exists(p + ".meta.json"):
            with open(p + ".meta.json") as f:
                meta = json.load(f)
        _check_meta(meta, nonzero)
        data = ckptr.restore(p, [np.asarray(l) for l in nonzero])
    else:
        f = np.load(path if path.endswith(".npz") else path + ".npz")
        meta = None
        if "__meta__" in f:
            meta = json.loads(bytes(f["__meta__"]).decode())
        _check_meta(meta, nonzero)
        n_data = (meta["n_leaves"] if meta is not None
                  else len([k for k in f.files if k.startswith("leaf_")]))
        if n_data != len(nonzero):
            raise ValueError(
                f"checkpoint holds {n_data} data leaves but `like` expects "
                f"{len(nonzero)} (different model, horizon, or library "
                "version)")
        data = [f[f"leaf_{i}"] for i in range(len(nonzero))]
    import jax.numpy as jnp
    it = iter(data)
    restored = []
    for l in leaves:
        if np.asarray(l).size == 0:
            restored.append(l)
            continue
        d = next(it)
        if np.shape(d) != np.shape(l):
            raise ValueError(
                f"checkpoint leaf shape {np.shape(d)} does not match "
                f"`like` leaf shape {np.shape(l)}")
        restored.append(jnp.asarray(
            d, l.dtype if hasattr(l, "dtype") else None))
    return jax.tree_util.tree_unflatten(treedef, restored)
