"""Particle-axis batching with per-leaf axis placement (time-major traces).

The SMC layer turns per-particle GFI calls into one ``jax.vmap`` over the
particle axis. WHERE that axis lands in each stored trace leaf is a pure
layout choice — and it decides the memory-traffic class of every
filter phase: with particle-major ``[N, T]`` leaves (vmap's default
``out_axes=0``) any dynamic-timestep column op (trace extension, windowed
rejuvenation) touches every tile of the leaf — a full O(N·T) pass,
making T-step filters O(N·T²). With **time-major** ``[T, N]`` leaves a
timestep is a contiguous row: ``dynamic_update_slice`` on the major axis
is O(N), and the resampling ancestry gather is a column gather.

This module is the single source of truth for that layout:

- :func:`axes_spec` asks each generative function where the particle axis
  lives in its trace (``GenFn.trace_axes``): :class:`~.combinators.Unfold`
  stacked step/retval leaves put it at position 1 (after the time axis),
  the traced active length ``t`` is SHARED across particles (spec ``None``,
  never stored per particle), everything else at 0.
- :func:`vmap_gfi` wraps ``jax.vmap`` with those per-leaf ``in_axes`` and
  derives ``out_axes`` from an ``eval_shape`` of the per-particle call — so
  scan-stacked leaves (whose natural vmap batch dim is already 1) are
  stored time-major with ZERO boundary transposes.
- :func:`tree_take` / :func:`tree_put` are the axis-aware gather/scatter
  used by resampling, views, and resizing.

Everything downstream (``smc/``, ``parallel/``) consumes these helpers and
never hardcodes axis 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .gfi import Trace

__all__ = [
    "axes_spec", "choice_axes", "vmap_gfi", "unbatch_avals",
    "tree_take", "tree_put", "tree_concat", "batch_size",
    "moveaxis_to_front", "check_batched_layout",
]


_SPEC_PER_PARTICLE = []


class perparticle_specs:
    """Context: spec derivation runs on PER-PARTICLE trees (leaves lack the
    particle axis — vmap ``out_axes`` derivation), so a leaf can host the
    axis at position ``ax`` whenever rank >= ax; on batched trees (the
    default) the leaf must already CONTAIN the axis (rank > ax), anything
    under-ranked being shared."""

    def __enter__(self):
        _SPEC_PER_PARTICLE.append(True)
        return self

    def __exit__(self, *exc):
        _SPEC_PER_PARTICLE.pop()
        return False


def _leaf_axis(x, axis, n=None):
    """Shape-aware spec for one leaf: a leaf that cannot hold the particle
    axis at ``axis`` — rank too small, or (when the particle count ``n`` is
    known) the wrong extent there — is SHARED across particles (spec
    ``None``): fully-constrained observation sites stored once instead of
    N-fold, scalar stored args of sub-calls. See :class:`perparticle_specs`
    for the per-particle-tree rank rule."""
    if axis is None:
        return None
    if _SPEC_PER_PARTICLE:
        return axis if jnp.ndim(x) >= axis else None
    if jnp.ndim(x) <= axis:
        return None
    if n is not None and jnp.shape(x)[axis] != n:
        return None
    return axis


def spec_n(score, axis):
    """The particle count implied by a trace's per-particle score leaf
    (the score ALWAYS carries the particle axis), or None when the tree is
    per-particle (scalar score)."""
    if _SPEC_PER_PARTICLE:
        return None
    s = jnp.shape(score)
    return s[axis] if len(s) > axis else None


def _const_spec(subtree, axis, n=None):
    """Spec pytree with every leaf at ``axis`` (no Trace recursion);
    shape-aware (see :func:`_leaf_axis`)."""
    return jax.tree_util.tree_map(lambda x: _leaf_axis(x, axis, n), subtree)


def gen_spec(subtree, axis, n=None):
    """Spec for an arbitrary container: leaves at ``axis`` (shape-aware —
    leaves that cannot hold the axis are shared, :func:`_leaf_axis`);
    nested traces defer to their generative function's ``trace_axes``."""
    return jax.tree_util.tree_map(
        lambda x: (x.gen_fn.trace_axes(x, axis) if isinstance(x, Trace)
                   else _leaf_axis(x, axis, n)),
        subtree, is_leaf=lambda x: isinstance(x, Trace))


def axes_spec(obj, axis: int = 0):
    """Per-leaf particle-axis spec for any pytree that may contain traces.

    The returned pytree has the SAME structure as ``obj`` (traces included,
    so it is valid as a full-resolution ``in_axes``/``out_axes`` for
    ``jax.vmap``); each leaf is an int axis position or ``None`` for leaves
    shared across particles. Top-level traces use the SMC convention that
    their args are one shared tuple (``args_shared=True``); sub-call traces
    nested inside keep per-particle args.
    """
    return jax.tree_util.tree_map(
        lambda x: (x.gen_fn.trace_axes(x, axis, args_shared=True)
                   if isinstance(x, Trace) else axis),
        obj, is_leaf=lambda x: isinstance(x, Trace))


def choice_axes(gen_fn, tr: Trace):
    """Particle-axis position for every address of ``trace_choices(tr)``,
    as ``{address: int}`` — the choicemap companion of :func:`axes_spec`
    (Unfold entries carry a leading time axis, so their particle axis is 1).
    """
    return gen_fn.trace_choice_axes(tr, 0)


def batch_size(traces: Trace) -> int:
    """Number of particles in a batched trace (the score is always a
    per-particle scalar, so its leading axis is the particle count)."""
    return jax.tree_util.tree_leaves(traces.score)[0].shape[0]


def spec_map(fn, tree, spec, *rest):
    """``tree_map`` pairing each leaf of ``tree`` with its spec element
    (``None`` spec elements are delivered to ``fn``, not treated as empty
    subtrees — the standard in_axes-style prefix flattening)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    spec_elems = treedef.flatten_up_to(spec)
    rest_leaves = [treedef.flatten_up_to(r) for r in rest]
    out = [fn(l, s, *extra) for l, s, *extra in
           zip(leaves, spec_elems, *rest_leaves)]
    return jax.tree_util.tree_unflatten(treedef, out)


def unbatch_avals(batched, spec):
    """Abstract per-particle values: drop the particle axis of each leaf at
    its spec position (``None`` leaves pass through unchanged)."""
    def one(x, ax):
        if ax is None or not hasattr(x, "shape") or len(x.shape) <= ax:
            return x
        shape = tuple(x.shape[:ax]) + tuple(x.shape[ax + 1:])
        return jax.ShapeDtypeStruct(shape, x.dtype)
    return spec_map(one, batched, spec)


def vmap_gfi(fn, *batched, in_specs=None):
    """``jax.vmap(fn)(*batched)`` with layout-aware axes.

    ``in_specs`` gives the particle-axis spec per argument (default: 0 for
    plain arrays — e.g. split PRNG keys — and :func:`axes_spec` for traces).
    ``out_axes`` is derived from the structure of an abstract per-particle
    evaluation: traces land at their generative function's preferred layout,
    everything else at axis 0.
    """
    if in_specs is None:
        in_specs = tuple(
            axes_spec(b) if _contains_trace(b) else _const_spec(b, 0)
            for b in batched)
    else:
        in_specs = tuple(in_specs)

    def per_particle(*xs):
        # suspend any enclosing batched interpretation: inside this vmap
        # the interpretation really is per-particle
        from .gfi import batched_interpretation
        with batched_interpretation(None):
            return fn(*xs)

    avals = tuple(unbatch_avals(b, s) for b, s in zip(batched, in_specs))
    out_shape = jax.eval_shape(per_particle, *avals)
    with perparticle_specs():  # out_shape leaves lack the particle axis
        out_spec = axes_spec(out_shape)
    return jax.vmap(per_particle, in_axes=in_specs, out_axes=out_spec)(*batched)


def _contains_trace(obj) -> bool:
    found = []

    def visit(x):
        if isinstance(x, Trace):
            found.append(True)
        return x

    jax.tree_util.tree_map(visit, obj, is_leaf=lambda x: isinstance(x, Trace))
    return bool(found)


def check_batched_layout(batched_tree, per_particle_fn, n: int,
                         context: str = "batched interpretation",
                         eval_args=()):
    """Trace-time guard against the batched-interpretation shape ambiguity
    (``core/gfi.py`` batchedness convention: leading dim == N means
    per-particle). A genuinely unbatched array whose leading dim happens to
    equal N is silently misread as per-particle inside a batched
    interpretation — this guard makes that a loud error: it abstractly
    evaluates ``per_particle_fn()`` (the SAME program, per-particle
    semantics, via ``jax.eval_shape`` — no FLOPs, one extra trace per
    compilation) and demands every leaf of ``batched_tree`` be exactly the
    per-particle leaf with one axis of extent ``n`` inserted at its
    particle-axis spec position (shared leaves: identical shapes).

    Raises ``ValueError`` naming the first inconsistent leaf. Gate:
    ``config.check_batched_layout``.
    """
    from .gfi import batched_interpretation

    def canonical(tr):
        # the storage-representation-free logical view (packed step
        # storages materialize): choice VALUES by address + retval + score.
        ch = tr.get_choices()
        return ({k: e.value for k, e in ch.entries.items()},
                tr.get_retval(), tr.score)

    def suspended(*xs):
        with batched_interpretation(None):
            return canonical(per_particle_fn(*xs))

    pp_ch, pp_rv, pp_sc = jax.eval_shape(suspended, *eval_args)
    b_ch, b_rv, b_sc = jax.eval_shape(canonical, batched_tree)
    if set(pp_ch) != set(b_ch):
        raise ValueError(
            f"{context}: batched and per-particle interpretations produced "
            f"different choice ADDRESS SETS — a model value whose leading "
            f"dim equals the particle count n={n} was likely misread as "
            f"per-particle (see core/gfi.py batchedness convention). "
            f"Batched-only: {sorted(set(b_ch) - set(pp_ch))}; "
            f"per-particle-only: {sorted(set(pp_ch) - set(b_ch))}")
    ch_ax = choice_axes(batched_tree.gen_fn, batched_tree)
    items = [(f"choice {k}", b_ch[k], pp_ch[k],
              _leaf_axis(b_ch[k], ch_ax.get(k, 0), n)) for k in b_ch]
    rv_spec = batched_tree.gen_fn.retval_axes(batched_tree)
    b_rl, rtd = jax.tree_util.tree_flatten(b_rv)
    items += [(f"retval leaf {i}", bl, pl, ax) for i, (bl, pl, ax) in
              enumerate(zip(b_rl, rtd.flatten_up_to(pp_rv),
                            rtd.flatten_up_to(rv_spec)))]
    items.append(("score", b_sc, pp_sc, 0))
    for name, bl, pl, ax in items:
        bs = tuple(jnp.shape(bl))
        ps = tuple(jnp.shape(pl))
        if ax is None:
            ok = bs == ps
            want = ps
        else:
            want = ps[:ax] + (n,) + ps[ax:]
            ok = bs == want
        if not ok:
            raise ValueError(
                f"{context}: {name} has batched shape {bs} but the "
                f"per-particle interpretation implies {want} "
                f"(per-particle shape {ps}, particle axis "
                f"{'shared' if ax is None else ax}, n={n}). A model value "
                f"whose leading dim coincidentally equals the particle "
                f"count was probably misread as per-particle — reshape it, "
                f"rename the axis, or pick a different particle count "
                f"(core/gfi.py batchedness convention); to bypass, set "
                f"genparticlefilters_tpu.config.check_batched_layout=False.")


# ---------------------------------------------------------------------------
# Axis-aware tree ops (gather / scatter / concat over the particle axis)
# ---------------------------------------------------------------------------

def tree_take(tree, idx, spec=None):
    """Gather ``leaf[..., idx, ...]`` along each leaf's particle axis
    (``spec=None`` computes it via :func:`axes_spec`). ``None``-spec leaves
    (shared across particles) pass through untouched."""
    if spec is None:
        spec = axes_spec(tree)
    idx = jnp.asarray(idx)

    def one(l, ax):
        if ax is None or jnp.ndim(l) <= ax:
            return l
        return jnp.take(l, idx, axis=ax)
    return spec_map(one, tree, spec)


def tree_put(full, block, idx, spec=None):
    """Scatter ``block`` into ``full`` at particle indices ``idx`` along
    each leaf's particle axis (functional ``full[..., idx, ...] = block``)."""
    if spec is None:
        spec = axes_spec(full)
    idx = jnp.asarray(idx)

    def one(f, ax, b):
        if ax is None or jnp.ndim(f) <= ax:
            return f
        sel = (slice(None),) * ax + (idx,)
        return f.at[sel].set(b)
    return spec_map(one, full, spec, block)


def tree_concat(a, b, spec=None):
    """Concatenate two batched trees along the particle axis."""
    if spec is None:
        spec = axes_spec(a)

    def one(x, ax, y):
        if ax is None or jnp.ndim(x) <= ax:
            return x
        return jnp.concatenate([x, y], axis=ax)
    return spec_map(one, a, spec, b)


def moveaxis_to_front(value, axis: int):
    """Move the particle axis of one array to position 0 (for user-facing
    particle-first views; identity when already leading)."""
    if axis == 0:
        return value
    return jnp.moveaxis(value, axis, 0)
