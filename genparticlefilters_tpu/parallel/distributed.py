"""Shard-local resampling and cross-shard exchange — explicit collectives.

The reference's sub-state resampling semantics
(/root/reference/src/resample.jl:205-218: preserve each block's total
weight, never touch the global LML) are exactly the correctness spec for
**shard-local resampling**: with the particle axis sharded over a mesh,
``pf_resample_blockwise(... mesh=mesh)`` runs the resample inside a
``jax.shard_map`` body — per-device, with ZERO inter-chip communication by
construction (the compiled HLO is asserted collective-free in
``tests/test_collectives.py``).

Periodic cross-shard mixing bounds the weight imbalance between shards:

- :func:`pf_rotate_blocks` — whole blocks ride a one-hop
  ``jax.lax.ppermute`` ring rotation (HLO: one
  ``collective-permute`` per state leaf, nothing else);
- :func:`pf_shuffle_blocks` — an equal-split block transpose via
  ``jax.lax.all_to_all`` (HLO: ``all-to-all``), each device keeping 1/K of
  its particles and sending K-1 equal slices.

Exact global resampling (:func:`~..smc.resample.pf_resample`) remains
available when the full ancestry permutation (an all-gather of the particle
state under GSPMD) is worth the bandwidth.

Every collective op also works without a mesh (``mesh=None``): the fallback
is an ordinary gather with the IDENTICAL permutation/offspring law, used as
the single-device semantics oracle (``tests/test_collectives.py`` pins the
two paths equal).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
from jax.sharding import PartitionSpec as P

from ..core.batching import axes_spec
from ..smc.resample import (multinomial_parents, residual_parents,
                            stratified_parents, systematic_parents,
                            _gather_traces, _resample_block,
                            _new_weights_sub)
from ..smc.state import ParticleFilterState
from ..utils.weights import safe_softmax, logsumexp
from .mesh import PARTICLE_AXIS, state_pspecs

__all__ = ["pf_resample_blockwise", "pf_shuffle_blocks", "pf_rotate_blocks",
           "block_log_weight_imbalance"]

_PARENT_FNS = {
    "multinomial": lambda k, w, lp: multinomial_parents(k, w),
    "residual": lambda k, w, lp: residual_parents(k, w),
    "stratified": lambda k, w, lp: stratified_parents(k, w,
                                                      log_priorities=lp),
    "systematic": lambda k, w, lp: systematic_parents(k, w,
                                                      log_priorities=lp),
}

def _check_blocks(n: int, n_blocks: int, mesh, axis_name: str):
    if n % n_blocks != 0:
        raise ValueError(f"n_particles={n} not divisible by {n_blocks}")
    if mesh is not None and mesh.shape[axis_name] != n_blocks:
        raise ValueError(
            f"mesh axis {axis_name!r} has {mesh.shape[axis_name]} devices "
            f"but n_blocks={n_blocks}")


def _traces_pspecs(state: ParticleFilterState, axis_name: str):
    """Per-leaf PartitionSpecs for the trace pytree (particle axis sharded,
    shared leaves replicated), as (leaves, treedef, specs, flags)."""
    n = state.n_particles
    leaves, treedef = jax.tree_util.tree_flatten(state.traces)
    axes = treedef.flatten_up_to(axes_spec(state.traces))
    flags, specs = [], []
    for l, ax in zip(leaves, axes):
        shape = jnp.shape(l) if hasattr(l, "shape") else ()
        if ax is not None and len(shape) > ax and shape[ax] == n:
            flags.append(ax)
            specs.append(P(*([None] * ax + [axis_name])))
        else:
            flags.append(None)
            specs.append(P())
    return leaves, treedef, specs, flags


def pf_resample_blockwise(key, state: ParticleFilterState, n_blocks: int,
                          method: str = "systematic", priority_fn=None,
                          mesh=None, axis_name: str = PARTICLE_AXIS,
                          sort_particles: bool | None = None
                          ) -> ParticleFilterState:
    """Resample independently inside each of ``n_blocks`` contiguous blocks
    of the particle axis, preserving each block's total weight (sub-state
    semantics, ref src/resample.jl:205-218).

    With ``mesh`` given (a 1-D mesh whose ``axis_name`` axis has exactly
    ``n_blocks`` devices), the resample runs inside ``jax.shard_map``:
    per-device and provably collective-free (asserted on compiled HLO in
    ``tests/test_collectives.py``). Without a mesh, a vmap over blocks
    computes the identical result on one device.

    ``sort_particles`` applies to ``method="stratified"`` only: the
    default (None/True) keeps the reference's weight-sorted stratified
    draws (variance reduction, src/resample.jl:154-158); ``False`` drops
    the pre-sort — the same stratified law with non-decreasing parents.
    """
    n = state.n_particles
    _check_blocks(n, n_blocks, mesh, axis_name)
    b = n // n_blocks
    if method not in _PARENT_FNS:
        raise ValueError(f"Resampling method {method!r} not recognized.")
    if method == "stratified" and sort_particles is False:
        parent_fn = lambda k, w, lp: stratified_parents(
            k, w, log_priorities=lp, sort_particles=False)
    else:
        parent_fn = _PARENT_FNS[method]
    keys = jr.split(key, n_blocks)

    if mesh is not None:
        leaves, treedef, specs, flags = _traces_pspecs(state, axis_name)

        def local(keys_l, lw, *tr_leaves):
            traces = jax.tree_util.tree_unflatten(treedef, tr_leaves)
            new_traces, parents, new_lw = _resample_block(
                keys_l[0], traces, lw, parent_fn, priority_fn)
            gparents = jax.lax.axis_index(axis_name) * b + parents
            return (new_lw, gparents.astype(jnp.int32),
                    *jax.tree_util.tree_leaves(new_traces))

        out = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), *specs),
            out_specs=(P(axis_name), P(axis_name), *specs),
        )(keys, state.log_weights, *leaves)
        new_lw, parents = out[0], out[1]
        new_traces = jax.tree_util.tree_unflatten(treedef, out[2:])
        return ParticleFilterState(new_traces, new_lw, state.log_ml_est,
                                   parents)

    custom = priority_fn is not None
    lw = state.log_weights.reshape(n_blocks, b)
    lp = priority_fn(lw) if custom else lw

    def per_block(k, lwb, lpb):
        w, _ = safe_softmax(lpb)
        local = parent_fn(k, w, lpb)
        nlw = _new_weights_sub(b, lwb, lpb, local, custom)
        return local, nlw

    local, new_lw = jax.vmap(per_block)(keys, lw, lp)
    offsets = (jnp.arange(n_blocks, dtype=jnp.int32) * b)[:, None]
    parents = (local + offsets).reshape(n)
    return ParticleFilterState(
        _gather_traces(state.traces, parents),
        new_lw.reshape(n), state.log_ml_est, parents)


def _apply_perm(state: ParticleFilterState, perm) -> ParticleFilterState:
    return ParticleFilterState(
        _gather_traces(state.traces, perm),
        state.log_weights[perm], state.log_ml_est, perm)


def pf_shuffle_blocks(state: ParticleFilterState, n_blocks: int,
                      mesh=None, axis_name: str = PARTICLE_AXIS
                      ) -> ParticleFilterState:
    """Deterministic equal-split block transpose: new block i holds the
    ``b/K`` particles ``[j*b + i*(b/K), j*b + (i+1)*(b/K))`` from every old
    block j (requires ``n_blocks**2 | n``). On a mesh this is ONE
    ``jax.lax.all_to_all`` per state leaf — each device keeps 1/K of its
    particles and exchanges K-1 equal slices; run it every few
    steps to decorrelate shards. Without a mesh: the identical permutation
    as a gather."""
    n = state.n_particles
    _check_blocks(n, n_blocks, mesh, axis_name)
    K = n_blocks
    b = n // K
    if b % K != 0:
        raise ValueError(
            f"shuffle needs equal splits: block size {b} not divisible by "
            f"n_blocks={K}")
    c = b // K

    if mesh is not None:
        leaves, treedef, specs, flags = _traces_pspecs(state, axis_name)

        def local(lw, *tr_leaves):
            def a2a(leaf, ax):
                if ax is None:
                    return leaf
                return jax.lax.all_to_all(leaf, axis_name, split_axis=ax,
                                          concat_axis=ax, tiled=True)
            new_leaves = [a2a(l, ax) for l, ax in zip(tr_leaves, flags)]
            new_lw = jax.lax.all_to_all(lw, axis_name, 0, 0, tiled=True)
            i = jax.lax.axis_index(axis_name)
            parents = (jnp.arange(K, dtype=jnp.int32)[:, None] * b
                       + i * c + jnp.arange(c, dtype=jnp.int32)[None, :]
                       ).reshape(b)
            return (new_lw, parents, *new_leaves)

        out = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(axis_name), *specs),
            out_specs=(P(axis_name), P(axis_name), *specs),
        )(state.log_weights, *leaves)
        new_traces = jax.tree_util.tree_unflatten(treedef, out[2:])
        return ParticleFilterState(new_traces, out[0], state.log_ml_est,
                                   out[1])

    # identical permutation, single-device gather: new (i, j*c + r) holds
    # old (j, i*c + r)
    perm = jnp.arange(n, dtype=jnp.int32).reshape(K, K, c)
    perm = perm.transpose(1, 0, 2).reshape(n)
    return _apply_perm(state, perm)


def pf_rotate_blocks(state: ParticleFilterState, n_blocks: int,
                     shift: int = 1, mesh=None,
                     axis_name: str = PARTICLE_AXIS) -> ParticleFilterState:
    """Ring-rotate whole blocks by ``shift``: block j's particles move to
    block ``(j+shift) mod K``. On a mesh this is ONE one-hop
    ``jax.lax.ppermute`` per state leaf (HLO:
    ``collective-permute``, asserted in ``tests/test_collectives.py``).
    Without a mesh: the identical permutation as a gather."""
    n = state.n_particles
    _check_blocks(n, n_blocks, mesh, axis_name)
    K = n_blocks
    b = n // K

    if mesh is not None:
        leaves, treedef, specs, flags = _traces_pspecs(state, axis_name)
        perm = [(j, (j + shift) % K) for j in range(K)]

        def local(lw, *tr_leaves):
            new_leaves = [
                jax.lax.ppermute(l, axis_name, perm) if ax is not None else l
                for l, ax in zip(tr_leaves, flags)]
            new_lw = jax.lax.ppermute(lw, axis_name, perm)
            j = jax.lax.axis_index(axis_name)
            src = jnp.mod(j - shift, K).astype(jnp.int32)
            parents = src * b + jnp.arange(b, dtype=jnp.int32)
            return (new_lw, parents, *new_leaves)

        out = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(axis_name), *specs),
            out_specs=(P(axis_name), P(axis_name), *specs),
        )(state.log_weights, *leaves)
        new_traces = jax.tree_util.tree_unflatten(treedef, out[2:])
        return ParticleFilterState(new_traces, out[0], state.log_ml_est,
                                   out[1])

    # identical permutation: new block j = old block (j - shift) mod K
    blocks = jnp.arange(n, dtype=jnp.int32).reshape(K, b)
    perm = jnp.roll(blocks, shift=shift, axis=0).reshape(n)
    return _apply_perm(state, perm)


def block_log_weight_imbalance(state: ParticleFilterState, n_blocks: int):
    """max−min of per-block total log weight: the trigger diagnostic for
    cross-shard exchange."""
    b = state.n_particles // n_blocks
    totals = logsumexp(state.log_weights.reshape(n_blocks, b), axis=1)
    return jnp.max(totals) - jnp.min(totals)
