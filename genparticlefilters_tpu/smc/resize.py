"""Particle-count resizing (ref: /root/reference/src/resize.jl).

- ``pf_resize`` dispatcher: multinomial / residual (ref lines 46-124) resize
  to a new static count, and **optimal** Fearnhead–Clifford resizing (ref
  lines 149-219): keep every particle with ``c·w ≥ 1`` deterministically and
  stratified-resample the rest so all survivors are unique.
- ``pf_replicate`` / ``pf_dereplicate`` (ref lines 236-297): integer
  fan-out/fan-in of the particle axis in contiguous or interleaved layout —
  pure reshape/gather.
- ``pf_coalesce`` (ref lines 309-334): merge duplicate particles. The
  static-shape formulation keeps all N slots: each duplicate group's weight
  is summed onto its first occurrence (+ log(n_unique/N), matching the
  reference), and the other slots get ``-inf`` weight — every weighted
  quantity (LML, ESS, posterior stats) matches the reference's compacted
  state exactly.
- ``pf_introduce`` (ref lines 351-421): append freshly generated particles,
  first folding any nonzero LML estimate back into the weights.

Target sizes are static Python ints (new compiled shapes) — resizing is a
shape change, so "recompile per size" is the static-shape semantics; for
online adaptation inside one jit use ``pf_replicate``/``pf_dereplicate``
(shape-static fan factors) or masked coalescing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr

from ..core.choicemap import ChoiceMap, EMPTY
from ..core.gfi import GenFn
from ..utils.weights import safe_softmax, apply_check, logsumexp
from .state import ParticleFilterState
from .resample import (multinomial_F, residual_F, counts_to_parents,
                       _gather_traces, _gather_from_F, _cumsum1, _cummax1)

__all__ = ["pf_resize", "pf_multinomial_resize", "pf_residual_resize",
           "pf_optimal_resize", "find_inv_w_threshold",
           "pf_replicate", "pf_dereplicate", "pf_coalesce", "pf_introduce"]


def _fold_lml(state: ParticleFilterState) -> ParticleFilterState:
    n = state.n_particles
    new_lml = state.log_ml_est + logsumexp(state.log_weights) - jnp.log(
        float(n))
    return new_lml


def _resize_weights(n_new, log_weights, log_priorities, parents, custom):
    """Post-resize weights (ref: src/resize.jl:423-438)."""
    if not custom:
        return jnp.zeros((n_new,), log_weights.dtype)
    lw = log_weights[parents] - log_priorities[parents]
    return lw + (jnp.log(float(n_new)) - logsumexp(lw))


def _resize_impl(key, state, n_particles, F_fn, priority_fn, check):
    custom = priority_fn is not None
    log_priorities = (priority_fn(state.log_weights) if custom
                      else state.log_weights)
    weights, invalid = safe_softmax(log_priorities)
    apply_check(invalid, check)
    new_lml = _fold_lml(state)
    new_traces, parents = _gather_from_F(
        state.traces, F_fn(key, weights, n_particles), n_particles)
    new_lw = _resize_weights(n_particles, state.log_weights, log_priorities,
                             parents, custom)
    return ParticleFilterState(new_traces, new_lw, new_lml, parents)


def pf_multinomial_resize(key, state, n_particles: int, priority_fn=None,
                          check="warn"):
    """(ref: src/resize.jl:46-67)"""
    with jax.named_scope("pf_resize"):
        return _resize_impl(key, state, n_particles, multinomial_F,
                            priority_fn, check)


def pf_residual_resize(key, state, n_particles: int, priority_fn=None,
                       check="warn"):
    """(ref: src/resize.jl:87-124)"""
    with jax.named_scope("pf_resize"):
        return _resize_impl(key, state, n_particles, residual_F,
                            priority_fn, check)


def _log_inv_w_threshold(log_weights, n_particles: int):
    """log c for optimal resizing (ref: src/resize.jl:203-219): the unique
    c with ``Σ min(1, c·wᵢ) = n_particles``.

    Entirely in log space so the tail of a peaked weight vector (which
    underflows a global f32 softmax) keeps full relative precision.
    Over ascending sorted normalized log-weights ℓ_i: A_i = #{ℓ > ℓ_i},
    log B_i = logsumexp(ℓ_{≤i}); the first i with exp(logB_i − ℓ_i) + A_i
    ≤ M gives log c = log(M − A_i) − log B_i.
    """
    from jax import lax
    n = log_weights.shape[0]
    lwn = log_weights - logsumexp(log_weights)
    ls = jnp.sort(lwn)
    logB = lax.associative_scan(jnp.logaddexp, ls)
    A = jnp.arange(n - 1, -1, -1, dtype=jnp.float32)
    ratio = jnp.exp(logB - ls)  # ≥ 1; inf for -inf tail entries (skipped)
    n_check = jnp.where(jnp.isfinite(ls), ratio + A, jnp.inf)
    ok = n_check <= n_particles * (1.0 + 1e-5)
    first = jnp.argmax(ok)
    log_c = jnp.log(jnp.maximum(n_particles - A[first], 1e-37)) - logB[first]
    return jnp.where(jnp.any(ok), log_c, jnp.log(float(n_particles)))


def find_inv_w_threshold(weights, n_particles: int):
    """Inverse-weight threshold c (reference-parity wrapper over the
    log-space core; ref: src/resize.jl:203-219)."""
    return jnp.exp(_log_inv_w_threshold(
        jnp.log(jnp.maximum(weights, 1e-37)), n_particles))


def pf_optimal_resize(key, state, n_particles: int, check="warn"):
    """Fearnhead–Clifford optimal resizing (ref: src/resize.jl:149-200):
    survivors are unique; kept particles retain (shifted) weights, resampled
    ones share the weight ``total/c``; requires n_particles ≤ current N."""
    n_old = state.n_particles
    m = int(n_particles)
    assert m <= n_old, "optimal resize cannot grow the particle count"
    weights, invalid = safe_softmax(state.log_weights)
    apply_check(invalid, check)
    lwn = state.log_weights - logsumexp(state.log_weights)
    log_c = _log_inv_w_threshold(state.log_weights, m)
    c = jnp.exp(log_c)
    keep = (log_c + lwn) >= 0.0

    n_keep = jnp.sum(keep.astype(jnp.int32))
    # stratified stream over non-kept particles with exactly m - n_keep
    # picks; renormalize the subset in LOG space (as the reference's
    # safe_softmax(log_weights[strat_idxs]) does, src/resize.jl:166-167) so
    # tail weights that underflowed globally keep relative precision
    lw_strat = jnp.where(keep, -jnp.inf, state.log_weights)
    mstrat = jnp.max(lw_strat)
    mstrat = jnp.where(jnp.isfinite(mstrat), mstrat, 0.0)
    es = jnp.where(keep, 0.0, jnp.exp(lw_strat - mstrat))
    p = es / jnp.maximum(jnp.sum(es), 1e-37)
    cum = _cumsum1(p)
    # counts formulation with the final cumulative pinned to n_res: exactly
    # n_res picks even under f32 cumsum roundoff (no unwritten ghost slots)
    n_res = (m - n_keep).astype(jnp.int32)
    u = jr.uniform(key, (), jnp.float32)
    F = jnp.floor(n_res.astype(jnp.float32) * cum - u).astype(jnp.int32) + 1
    F = jnp.clip(F, 0, n_res).at[-1].set(n_res)
    F = _cummax1(F)
    counts = F - jnp.concatenate([jnp.zeros((1,), F.dtype), F[:-1]])
    res_parents = counts_to_parents(counts, m)  # first n_res entries valid

    # output layout: kept first (index order), then the resampled picks
    rank_keep = _cumsum1(keep.astype(jnp.int32)) - 1
    pos_keep = jnp.where(keep, rank_keep, m)  # m => dropped
    src = jnp.arange(n_old, dtype=jnp.int32)
    j = jnp.arange(m, dtype=jnp.int32)
    pos_res = jnp.where(j < n_res, n_keep + j, m)
    parents = (jnp.zeros((m,), jnp.int32)
               .at[pos_res].set(res_parents, mode="drop")
               .at[pos_keep].set(src, mode="drop"))

    # weights (ref: src/resize.jl:188-195)
    log_n_ratio = jnp.log(float(m)) - jnp.log(float(n_old))
    log_tot = logsumexp(state.log_weights)
    kept_lw = state.log_weights + log_n_ratio
    res_lw = log_tot - log_c + log_n_ratio
    new_lw = jnp.full((m,), res_lw, state.log_weights.dtype).at[
        pos_keep].set(kept_lw, mode="drop")

    new_traces = _gather_traces(state.traces, parents)
    return ParticleFilterState(new_traces, new_lw, state.log_ml_est, parents)


_RESIZE_METHODS = {
    "multinomial": pf_multinomial_resize,
    "residual": pf_residual_resize,
    "optimal": pf_optimal_resize,
}


def pf_resize(key, state, n_particles: int, method: str = "multinomial",
              **kwargs):
    """Dispatch by method name (ref: src/resize.jl:16-27)."""
    try:
        fn = _RESIZE_METHODS[method]
    except KeyError:
        raise ValueError(f"Resampling method {method!r} not recognized.")
    return fn(key, state, n_particles, **kwargs)


# ---------------------------------------------------------------------------
# Replicate / dereplicate (ref: src/resize.jl:236-297)
# ---------------------------------------------------------------------------

def _rep_idx(n, k, layout):
    base = jnp.arange(n, dtype=jnp.int32)
    if layout == "contiguous":
        return jnp.repeat(base, k)
    if layout == "interleaved":
        return jnp.tile(base, k)
    raise ValueError(f"unknown layout {layout!r}")


def pf_replicate(state, n_replicates: int, layout: str = "contiguous"
                 ) -> ParticleFilterState:
    """Each particle × k (ref: src/resize.jl:236-244): contiguous blocks
    or interleaved stride-N copies; weights replicated."""
    idx = _rep_idx(state.n_particles, n_replicates, layout)
    return ParticleFilterState(
        _gather_traces(state.traces, idx),
        state.log_weights[idx], state.log_ml_est, idx)


def pf_dereplicate(key, state, n_replicates: int, layout: str = "contiguous",
                   method: str = "keepfirst") -> ParticleFilterState:
    """Inverse of replicate (ref: src/resize.jl:267-297): ``keepfirst``
    (exact inverse, original weights) or ``sample`` (weighted draw per block,
    block-average weight)."""
    n_old = state.n_particles
    k = int(n_replicates)
    assert n_old % k == 0
    n_new = n_old // k
    if layout == "contiguous":
        blocks = jnp.arange(n_old, dtype=jnp.int32).reshape(n_new, k)
    elif layout == "interleaved":
        blocks = jnp.arange(n_old, dtype=jnp.int32).reshape(k, n_new).T
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if method == "keepfirst":
        idx = blocks[:, 0]
        new_lw = state.log_weights[idx]
    elif method == "sample":
        blw = state.log_weights[blocks]  # [n_new, k]
        keys = jr.split(key, n_new)
        pick = jax.vmap(lambda kk, lw: jr.categorical(kk, lw))(keys, blw)
        idx = blocks[jnp.arange(n_new), pick]
        new_lw = logsumexp(blw, axis=1) - jnp.log(float(k))
    else:
        raise ValueError(f"unknown method {method!r}")
    return ParticleFilterState(
        _gather_traces(state.traces, idx), new_lw, state.log_ml_est, idx)


# ---------------------------------------------------------------------------
# Coalesce (ref: src/resize.jl:309-334)
# ---------------------------------------------------------------------------

def _coalesce_key_matrix(state, by):
    from ..core.batching import choice_axes, moveaxis_to_front
    if by is None:
        # masked (absent) values are zeroed so only *present* choices
        # distinguish particles (Gen's choicemap equality semantics);
        # time-major entries are moved particle-first for row keys
        traces = state.traces
        axes = choice_axes(traces.gen_fn, traces)
        leaves = []
        for k, e in sorted(traces.get_choices().entries.items(),
                           key=lambda kv: repr(kv[0])):
            v = jnp.asarray(e.value)
            if e.mask is not True:
                v = jnp.where(e.mask_array(), v, jnp.zeros_like(v))
            leaves.append(moveaxis_to_front(v, axes.get(k, 0)))
    else:
        out = by(state.traces)
        leaves = [jnp.asarray(l) for l in jax.tree_util.tree_leaves(out)]
    n = state.n_particles
    cols = []
    for l in leaves:
        cols.extend(_exact_key_cols(l.reshape(n, -1)))
    return jnp.concatenate(cols, axis=1)  # [N, D] int32


def _exact_key_cols(v):
    """Lossless int32 key columns for one [N, D] leaf. A float32 cast would
    collapse int32 choices above 2**24 (and distinct float bit patterns that
    round together) into one group — the reference keys on exact choicemap
    equality (src/resize.jl:309-334), so compare bit patterns instead."""
    if v.dtype == jnp.bool_:
        return [v.astype(jnp.int32)]
    if jnp.issubdtype(v.dtype, jnp.floating):
        # canonicalize -0.0 -> +0.0 so value equality matches bit equality
        v = jnp.where(v == 0, jnp.zeros((), v.dtype), v)
        u = jax.lax.bitcast_convert_type(
            v, jnp.dtype(f"uint{8 * v.dtype.itemsize}"))
    elif jnp.issubdtype(v.dtype, jnp.integer):
        u = v
    else:
        raise TypeError(f"pf_coalesce: unsupported key dtype {v.dtype}")
    if u.dtype.itemsize < 4:
        return [u.astype(jnp.int32)]
    if u.dtype.itemsize == 4:
        if u.dtype == jnp.int32:
            return [u]
        return [jax.lax.bitcast_convert_type(u, jnp.int32)]
    # 64-bit: split into two exact 32-bit halves
    u = u.astype(jnp.uint64) if u.dtype != jnp.uint64 else u
    hi = (u >> 32).astype(jnp.uint32)
    lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    return [jax.lax.bitcast_convert_type(hi, jnp.int32),
            jax.lax.bitcast_convert_type(lo, jnp.int32)]


def pf_coalesce(state, by=None) -> ParticleFilterState:
    """Merge duplicate particles (ref: src/resize.jl:309-334). Static-shape:
    each duplicate group's first occurrence carries the merged weight
    ``log Σ exp(w) + log(n_unique/N)``; the other slots get -inf weight.
    ``by`` maps batched traces to an array of group keys (default: the
    flattened choicemap)."""
    n = state.n_particles
    mat = _coalesce_key_matrix(state, by)
    # lexicographic sort by columns (stable, last column first)
    order = jnp.arange(n, dtype=jnp.int32)
    for col in range(mat.shape[1] - 1, -1, -1):
        order = order[jnp.argsort(mat[order, col], stable=True)]
    sorted_rows = mat[order]
    differs = jnp.any(sorted_rows[1:] != sorted_rows[:-1], axis=1)
    gid_sorted = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                  _cumsum1(differs.astype(jnp.int32))])
    gid = jnp.zeros((n,), jnp.int32).at[order].set(gid_sorted)
    n_unique = gid_sorted[-1] + 1
    # representative = min original index per group
    rep = jnp.full((n,), n, jnp.int32).at[gid].min(jnp.arange(n, dtype=jnp.int32))
    rep_per_particle = rep[gid]
    # merged weights per group (log-sum-exp via max-shift + segment sum)
    mshift = jnp.max(jnp.where(jnp.isfinite(state.log_weights),
                               state.log_weights, -jnp.inf))
    mshift = jnp.where(jnp.isfinite(mshift), mshift, 0.0)
    seg = jax.ops.segment_sum(jnp.exp(state.log_weights - mshift), gid,
                              num_segments=n)
    merged = jnp.log(jnp.maximum(seg, 1e-37)) + mshift
    log_ratio = jnp.log(n_unique.astype(jnp.float32)) - jnp.log(float(n))
    is_rep = jnp.arange(n, dtype=jnp.int32) == rep_per_particle
    new_lw = jnp.where(is_rep, merged[gid] + log_ratio, -jnp.inf)
    return ParticleFilterState(state.traces, new_lw, state.log_ml_est,
                               jnp.arange(n, dtype=jnp.int32))


# ---------------------------------------------------------------------------
# Introduce (ref: src/resize.jl:351-421)
# ---------------------------------------------------------------------------

def pf_introduce(key, state, observations: ChoiceMap, n_particles: int,
                 model: GenFn | None = None, model_args=None,
                 proposal: GenFn | None = None, proposal_args=None
                 ) -> ParticleFilterState:
    """Append ``n_particles`` fresh constrained particles; any nonzero LML
    estimate is folded back into the existing weights first
    (ref: src/resize.jl:361-365)."""
    from ..core.batching import vmap_gfi, tree_concat
    model = model if model is not None else state.traces.get_gen_fn()
    if model_args is None:
        model_args = state.traces.args  # shared across particles
    lw = state.log_weights + state.log_ml_est
    keys = jr.split(key, n_particles)
    if proposal is None:
        new_traces, ws = vmap_gfi(
            lambda k: model.generate(k, model_args, observations), keys)
    else:
        p_args = tuple(proposal_args or ())

        def one(k):
            k1, k2 = jr.split(k)
            prop_choices, prop_w, _ = proposal.propose(k1, p_args)
            tr, model_w = model.generate(
                k2, model_args, observations.merge(prop_choices))
            return tr, model_w - prop_w
        new_traces, ws = vmap_gfi(one, keys)
    traces = tree_concat(state.traces, new_traces)
    n_total = state.n_particles + n_particles
    return ParticleFilterState(
        traces, jnp.concatenate([lw, ws]),
        jnp.asarray(0.0, jnp.float32),
        jnp.arange(n_total, dtype=jnp.int32))
