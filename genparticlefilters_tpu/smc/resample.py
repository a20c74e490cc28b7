"""Resampling (ref: /root/reference/src/resample.jl).

Methods: multinomial (ref lines 48-65), residual (85-120), stratified
(143-175), plus systematic (single shared uniform; standard variance
reduction, used by BASELINE config 2). All support ``priority_fn`` and the
``check`` policy, fold the LML estimate *before* resampling
(``update_lml_est!``, ref lines 178-182), and reproduce the post-resample
weight semantics exactly (ref lines 190-218): zeros (or weight/priority
ratio summing to n) for full states; block-total-preserving weights for
sub-states, whose LML is never touched (ref lines 185-187).

Formulation: every data-dependent Julia loop becomes O(N) static-shape
arithmetic. Systematic/stratified draws and residual's deterministic block
have closed-form cumulative offspring counts ``F``; multinomial draws (and
residual's remainder) count sorted uniforms below each cumulative weight.
``F`` becomes the parent vector by a scatter + ``cummax``
(``counts_to_parents``). The ancestor gather ``traces[parents]`` packs all
4-byte trace leaves into one [D, N] matrix and gathers its columns once;
on a single GPU one Pallas/Triton kernel does both steps from ``F``
(``_gather_from_F``). Cross-shard exchange lives in ``parallel/``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr

from ..utils.weights import safe_softmax, apply_check, logsumexp
from .state import ParticleFilterState, ParticleFilterSubState

__all__ = ["pf_resample", "pf_multinomial_resample", "pf_residual_resample",
           "pf_stratified_resample", "pf_systematic_resample",
           "multinomial_parents", "residual_parents", "stratified_parents",
           "systematic_parents", "stratified_F", "systematic_F",
           "multinomial_F", "residual_F"]


# ---------------------------------------------------------------------------
# 1-D prefix scans, blocked as [n/512, 512]: a per-row scan plus a small
# cross-row offset scan. Used for every [N]-sized scan on the resampling
# paths; small n keeps the XLA op. On an H100 (700 W) at n=1M the blocked
# form and ``jnp.cumsum`` measured 0.18-0.21 ms against 0.17-0.25 ms (f32)
# and 0.15-0.19 ms against 0.14-0.25 ms (int32) over two runs (PERF.md).
# ---------------------------------------------------------------------------

_BLK_SCAN = 512


def _cumsum1(x):
    """Inclusive 1-D cumsum, blocked for large n (f32/int32)."""
    n = x.shape[0]
    if n < 8 * _BLK_SCAN or n % 1 != 0:
        return jnp.cumsum(x)
    L = _BLK_SCAN
    K = n // L
    r = x[:K * L].reshape(K, L)
    within = jnp.cumsum(r, axis=1)
    offs = jnp.cumsum(within[:, -1])
    offs = jnp.concatenate([jnp.zeros((1,), x.dtype), offs[:-1]])
    out = (within + offs[:, None]).reshape(K * L)
    if K * L != n:
        tail = jnp.cumsum(x[K * L:]) + out[-1]
        out = jnp.concatenate([out, tail])
    return out


def _cummax1(x):
    """Inclusive 1-D cummax, blocked for large n."""
    n = x.shape[0]
    if n < 8 * _BLK_SCAN:
        return jax.lax.cummax(x)
    lo = (jnp.finfo(x.dtype).min if jnp.issubdtype(x.dtype, jnp.floating)
          else jnp.iinfo(x.dtype).min)
    L = _BLK_SCAN
    K = n // L
    r = x[:K * L].reshape(K, L)
    within = jax.lax.cummax(r, axis=1)
    offs = jax.lax.cummax(within[:, -1])
    offs = jnp.concatenate([jnp.full((1,), lo, x.dtype), offs[:-1]])
    out = jnp.maximum(within, offs[:, None]).reshape(K * L)
    if K * L != n:
        tail = jnp.maximum(jax.lax.cummax(x[K * L:]), out[-1])
        out = jnp.concatenate([out, tail])
    return out


# ---------------------------------------------------------------------------
# Parent-index kernels (pure [N]-weights -> [N]-parents functions)
# ---------------------------------------------------------------------------

def multinomial_parents(key, weights, n_out: int | None = None):
    """IID categorical ancestors (ref: src/resample.jl:59), emitted in
    clustered (non-decreasing) order — the offspring multiset is exchangeable
    over output slots, so this is distributionally identical to iid slot
    order for every resampling use, and the clustering makes the ancestry
    gather read nearly contiguous columns.

    Sort-free: sorted uniforms by exponential spacings + a merge count
    (``_merge_count``) — never ``jax.random.categorical`` ([n_out, N]
    Gumbel matrix).
    """
    n = weights.shape[0]
    n_out = n if n_out is None else n_out
    return _F_to_parents(multinomial_F(key, weights, n_out), n_out)


def residual_parents(key, weights, n_out: int | None = None):
    """⌊n·w⌋ deterministic copies plus a multinomial remainder on the
    residual fractions (ref: src/resample.jl:96-115), in clustered
    per-particle order (same offspring-count law; see
    ``multinomial_parents`` on slot exchangeability)."""
    n = weights.shape[0]
    n_out = n if n_out is None else n_out
    return _F_to_parents(residual_F(key, weights, n_out), n_out)


def counts_to_parents(counts, n_out: int):
    """Turn per-particle offspring counts (Σ = n_out) into the parent index
    vector [n_out] in particle order — sort-free: scatter each particle's
    index at its first output slot, then forward-fill with a cummax.
    O(N) compute / O(N) memory."""
    counts = counts.astype(jnp.int32)
    cum = _cumsum1(counts)
    starts = cum - counts
    n = counts.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    slots = jnp.where(counts > 0, starts, n_out)  # dropped when count==0
    seeded = jnp.full((n_out,), -1, jnp.int32).at[slots].max(idx, mode="drop")
    return _cummax1(seeded).astype(jnp.int32)


def _pinned_F(cdf_hits, n_out: int):
    """Monotone cumulative hit counts with total pinned to n_out (guards f32
    cumsum roundoff in the last slot). ``F_i`` = number of output slots with
    parent <= i; output j's parent is ``#{i : F_i <= j}``."""
    F = jnp.clip(cdf_hits, 0, n_out).at[-1].set(n_out)
    return _cummax1(F)  # enforce monotone under roundoff


def stratified_F(key, weights, n_out: int | None = None):
    """Pinned cumulative hit counts for stratified resampling: one uniform
    per stratum [i/n,(i+1)/n); F_i = ⌊c_i⌋ + [v_{⌊c_i⌋} ≤ c_i − ⌊c_i⌋] with
    c_i = n·cumsum(w)_i — one gather instead of a sort-based search."""
    n_out = weights.shape[0] if n_out is None else n_out
    v = jr.uniform(key, (n_out,), dtype=jnp.float32)
    c = n_out * _cumsum1(weights)
    m = jnp.floor(c).astype(jnp.int32)
    mc = jnp.clip(m, 0, n_out - 1)
    frac_hit = (v[mc] <= c - m.astype(jnp.float32)) & (m < n_out)
    F = jnp.clip(m, 0, n_out) + frac_hit.astype(jnp.int32)
    return _pinned_F(F, n_out)


def systematic_F(key, weights, n_out: int | None = None):
    """Pinned cumulative hit counts for systematic resampling: single shared
    uniform; F_i = ⌊n·cumsum(w)_i − u0⌋ + 1."""
    n_out = weights.shape[0] if n_out is None else n_out
    u0 = jr.uniform(key, (), dtype=jnp.float32)
    c = n_out * _cumsum1(weights) - u0
    return _pinned_F(jnp.floor(c).astype(jnp.int32) + 1, n_out)


def _sorted_uniforms_cum(key, n: int):
    """Cumulative exponential spacings ``ce`` [n+1]: the order statistics of
    n Uniform(0,1) draws are ``ce[j]/ce[n]`` for j<n — O(n), no sort.
    cummax keeps them non-decreasing (a parallel-prefix cumsum is not
    locally monotone under f32 rounding)."""
    return _cummax1(_cumsum1(jr.exponential(key, (n + 1,), jnp.float32)))


def _merge_count(c, u):
    """``F_i = #{j : u_j ≤ c_i}`` — ``jnp.searchsorted(u, c, side="right")``
    — for ascending non-negative f32 ``c`` [n] and ascending ``u`` [m]
    (both < 2) via ONE bitonic **merge** network, not a full bitonic sort.
    A parallel-prefix cumsum is not locally monotone under f32 rounding, so
    callers pass ``c`` through ``_cummax1`` first.

    The origin tag rides in the LOW BIT of an order-preserving int32 view of
    the key (positive-f32 bitcast is monotone; ``<< 1`` is safe for values
    < 2), which (a) makes each compare-exchange a single-array min/max (no
    payload swap) and (b) breaks u==c ties as u-before-c — exactly the
    ``side='right'`` counting semantics, bit-exactly. ``[c_asc, +inf_pad,
    u_desc]`` is bitonic, so log2(n+m) roll/min/max passes sort it: pure
    elementwise work plus one unique-index scatter."""
    n, m = c.shape[0], u.shape[0]
    Mp = 1 << max(1, (n + m - 1).bit_length())
    ck = (jax.lax.bitcast_convert_type(c, jnp.int32) << 1) | 1
    uk = jax.lax.bitcast_convert_type(u, jnp.int32) << 1
    pad = jnp.iinfo(jnp.int32).max - 1  # even: tag bit 0, never read as c
    z = jnp.concatenate([
        ck, jnp.full((Mp - n - m,), pad, jnp.int32), uk[::-1]])
    i = jnp.arange(Mp, dtype=jnp.int32)
    d = Mp >> 1
    while d >= 1:
        # stage-d pairing (i <-> i+d within 2d blocks): positions with
        # bit d clear take min with the +d partner, others max with -d
        lo_half = (i & d) == 0
        z = jnp.where(lo_half, jnp.minimum(z, jnp.roll(z, -d)),
                      jnp.maximum(z, jnp.roll(z, d)))
        d >>= 1
    tags = z & 1
    r = _cumsum1(tags) - tags              # rank among c at c slots
    F_at_slot = i - r                        # u's before this c
    return jnp.zeros((n,), jnp.int32).at[
        jnp.where(tags == 1, r, n)].set(F_at_slot, mode="drop")


def multinomial_F(key, weights, n_out: int | None = None):
    """Pinned cumulative hit counts for multinomial resampling, sort-free:
    sorted uniforms via exponential spacings, then
    F_i = #{j : U_(j) ≤ cumw_i} by a bitonic-merge count. Distributionally
    identical to iid categorical ancestry (the offspring multiset is
    exchangeable over output slots); emits *clustered* (non-decreasing)
    parents."""
    n_out = weights.shape[0] if n_out is None else n_out
    ce = _sorted_uniforms_cum(key, n_out)
    c = _cummax1(_cumsum1(weights))  # the merge needs ascending c
    u = ce[:-1] / ce[-1]
    F = _merge_count(c / jnp.maximum(c[-1], 1e-37), u)
    return _pinned_F(F, n_out)


def residual_F(key, weights, n_out: int | None = None):
    """Pinned cumulative hit counts for residual resampling, sort-free:
    ⌊n·w⌋ deterministic offspring per particle plus multinomial counts on
    the residual fractions (exactly R = n − Σ⌊n·w⌋ draws, realized as the
    first R sorted uniforms from exponential spacings). Same offspring-count
    law as the reference's residual method (ref: src/resample.jl:96-115),
    clustered slot order."""
    n_out = weights.shape[0] if n_out is None else n_out
    scaled = n_out * weights
    det = jnp.floor(scaled).astype(jnp.int32)
    n_res = n_out - jnp.sum(det)
    resid = scaled - det.astype(weights.dtype)
    rcum = _cummax1(_cumsum1(resid))  # the merge needs ascending c
    ce = _sorted_uniforms_cum(key, n_out)
    denom = ce[n_res]  # S_{R+1}: U_(j) = ce[j]/denom for j < R
    j = jnp.arange(n_out, dtype=jnp.int32)
    # padding past R must sort above every real key yet stay < 2.0 so the
    # low-bit tag packing in _merge_count stays order-preserving
    u = jnp.where(j < n_res, jnp.minimum(ce[:-1] / denom, 1.5), 1.75)
    F_res = _merge_count(rcum / jnp.maximum(rcum[-1], 1e-37), u)
    return _pinned_F(_cumsum1(det) + F_res, n_out)


def _F_to_parents(F, n_out: int):
    prev = jnp.concatenate([jnp.zeros((1,), F.dtype), F[:-1]])
    return counts_to_parents(F - prev, n_out)


def stratified_parents(key, weights, n_out: int | None = None,
                       log_priorities=None, sort_particles: bool = True):
    """One uniform per stratum [i/n,(i+1)/n), optional sort by weight desc
    first (ref: src/resample.jl:154-170)."""
    n = weights.shape[0]
    n_out = n if n_out is None else n_out
    if sort_particles:
        keysort = weights if log_priorities is None else log_priorities
        order = jnp.argsort(-keysort, stable=True).astype(jnp.int32)
        w = weights[order]
    else:
        order = None
        w = weights
    parents = _F_to_parents(stratified_F(key, w, n_out), n_out)
    return parents if order is None else order[parents]


def systematic_parents(key, weights, n_out: int | None = None,
                       log_priorities=None, sort_particles: bool = False):
    """Single shared uniform offset across all strata (lowest-variance
    single-pass scheme; companion to stratified)."""
    n = weights.shape[0]
    n_out = n if n_out is None else n_out
    if sort_particles:
        keysort = weights if log_priorities is None else log_priorities
        order = jnp.argsort(-keysort, stable=True).astype(jnp.int32)
        w = weights[order]
    else:
        order = None
        w = weights
    parents = _F_to_parents(systematic_F(key, w, n_out), n_out)
    return parents if order is None else order[parents]


# ---------------------------------------------------------------------------
# State-level resampling
# ---------------------------------------------------------------------------

def _flatten_with_axes(traces):
    """(leaves, per-leaf particle-axis list, treedef) — the axis placement
    comes from the trace's generative function (core/batching.py)."""
    from ..core.batching import axes_spec
    leaves, treedef = jax.tree_util.tree_flatten(traces)
    axes = treedef.flatten_up_to(axes_spec(traces))
    return leaves, axes, treedef


def _pack_rows(leaves, axes):
    """Pack gatherable 4-byte leaves into lane-dense [w, N] int32 row
    blocks — particle axis LAST, so the time-major stacked leaves ([T, N])
    concatenate with zero data movement. Returns (rows, meta) where
    meta = (dtype, shape, width, particle_axis); width 0 marks pass-through
    leaves (odd dtypes, scalars, or particle-shared ``None``-axis leaves)."""
    rows, meta = [], []
    for l, ax in zip(leaves, axes):
        packable = (hasattr(l, "dtype") and ax is not None
                    and l.ndim > ax and l.size > 0
                    and (l.dtype in (jnp.int32, jnp.uint32, jnp.bool_)
                         or l.dtype == jnp.float32))
        if not packable:
            rows.append(None)
            meta.append((getattr(l, "dtype", None), jnp.shape(l), 0, ax))
            continue
        if l.dtype == jnp.float32:
            flat = jax.lax.bitcast_convert_type(l, jnp.int32)
        elif l.dtype == jnp.bool_:
            flat = l.astype(jnp.int32)
        else:
            flat = l if l.dtype == jnp.int32 else l.astype(jnp.int32)
        n = l.shape[ax]
        if ax != l.ndim - 1:
            flat = jnp.moveaxis(flat, ax, -1)
        rows.append(flat.reshape(-1, n))
        meta.append((l.dtype, l.shape, l.size // n, ax))
    return rows, meta


def _seg_to_leaf(seg, dtype, shape, ax, n):
    """One gathered row block [w, n] -> the trace leaf (bitcast + reshape +
    axis restore; a packed-storage mat leaf comes back shape-identical with
    zero movement)."""
    if dtype == jnp.float32:
        seg = jax.lax.bitcast_convert_type(seg, jnp.float32)
    elif dtype == jnp.bool_:
        seg = seg != 0
    elif dtype != jnp.int32:
        seg = seg.astype(dtype)
    new_shape = tuple(shape[:ax]) + tuple(shape[ax + 1:]) + (n,)
    if seg.shape != new_shape:
        seg = seg.reshape(new_shape)
    if ax != len(shape) - 1:
        seg = jnp.moveaxis(seg, -1, ax)
    return seg


def _unpack_rows(big, leaves, meta, parents, n):
    """Rebuild trace leaves from the gathered lane-dense [D, n] matrix
    (sublane slices; time-major leaves reshape back with zero movement)."""
    out_leaves = []
    off = 0
    for l, (dtype, shape, width, ax) in zip(leaves, meta):
        if width == 0:
            if ax is None or jnp.ndim(l) <= ax:
                out_leaves.append(l)
            else:
                out_leaves.append(jnp.take(l, parents, axis=ax))
            continue
        seg = big[off] if width == 1 else big[off:off + width]
        off += width
        out_leaves.append(_seg_to_leaf(seg, dtype, shape, ax, n))
    return out_leaves


def _pack(traces):
    """(packed [D, N] int32 matrix or None, leaves, meta, treedef)."""
    leaves, axes, treedef = _flatten_with_axes(traces)
    rows, meta = _pack_rows(leaves, axes)
    packed = [r for r in rows if r is not None]
    big = None
    if packed:
        big = jnp.concatenate(packed, axis=0) if len(packed) > 1 else packed[0]
    return big, leaves, meta, treedef


def _gather_traces(traces, parents):
    """Ancestry gather ``traces[parents]`` over the particle axis.

    All 4-byte leaves are packed into a single [D, N] matrix (time-major
    stacked leaves concatenate for free), gathered in ONE column gather,
    and split back.
    """
    big, leaves, meta, treedef = _pack(traces)
    if big is not None:
        big = jnp.take(big, parents, axis=1)
    out_leaves = _unpack_rows(big, leaves, meta, parents, parents.shape[0])
    return jax.tree_util.tree_unflatten(treedef, out_leaves)


def _use_triton_gather() -> bool:
    """The one choice of gather path: the Triton kernel
    (``ops/triton_gather.py``) on a GPU backend with a single device, the
    XLA column gather everywhere else. A ``pallas_call`` does not partition
    under GSPMD, so with several devices visible (where the particle axis
    may be sharded) the XLA path is taken."""
    return jax.default_backend() == "gpu" and jax.device_count() == 1


def _gather_from_F(traces, F, n_out: int):
    """``(traces[parents], parents)`` for the clustered parents
    ``parents_j = #{i : F_i <= j}`` encoded by the cumulative offspring
    counts ``F``."""
    big, leaves, meta, treedef = _pack(traces)
    if big is not None and _use_triton_gather():
        from ..ops.triton_gather import resample_gather
        big, parents = resample_gather(big, F, n_out)
    else:
        parents = _F_to_parents(F, n_out)
        if big is not None:
            big = jnp.take(big, parents, axis=1)
    out_leaves = _unpack_rows(big, leaves, meta, parents, n_out)
    return jax.tree_util.tree_unflatten(treedef, out_leaves), parents


def _new_weights_full(n, log_weights, log_priorities, parents, custom):
    """Post-resample weights, full state (ref: src/resample.jl:190-202)."""
    if not custom:
        return jnp.zeros((n,), log_weights.dtype)
    lw = log_weights[parents] - log_priorities[parents]
    return lw + (jnp.log(float(n)) - logsumexp(lw))


def _new_weights_sub(n, log_weights, log_priorities, parents, custom):
    """Post-resample weights, sub-state: preserve the block's total weight
    (ref: src/resample.jl:205-218)."""
    if not custom:
        avg = logsumexp(log_weights) - jnp.log(float(n))
        return jnp.full((n,), avg, log_weights.dtype)
    lw = log_weights[parents] - log_priorities[parents]
    return lw + (logsumexp(log_weights) - logsumexp(lw))


def _resample_block(key, traces, log_weights, parent_fn, priority_fn=None):
    """Block-local resample preserving the block's total weight (sub-state
    semantics, ref: src/resample.jl:205-218) on bare (traces, log_weights).
    This is the per-shard body of the shard_map blockwise path
    (``parallel/distributed.py``). Returns
    ``(new_traces, parents_local, new_log_weights)``."""
    b = log_weights.shape[0]
    custom = priority_fn is not None
    lp = priority_fn(log_weights) if custom else log_weights
    w, _ = safe_softmax(lp)
    parents = parent_fn(key, w, lp)
    new_traces = _gather_traces(traces, parents)
    new_lw = _new_weights_sub(b, log_weights, lp, parents, custom)
    return new_traces, parents, new_lw


def _resample_impl(key, state, priority_fn, check, F_fn=None,
                   parent_fn=None):
    """Shared body of the ``pf_*_resample`` verbs. Clustered methods pass
    ``F_fn(key, weights, n_out)`` (cumulative offspring counts); the
    weight-sorted ones pass ``parent_fn(key, weights, log_priorities)``."""
    is_sub = isinstance(state, ParticleFilterSubState)
    log_weights = state.log_weights
    n = state.n_particles
    custom = priority_fn is not None
    log_priorities = priority_fn(log_weights) if custom else log_weights
    weights, invalid = safe_softmax(log_priorities)
    apply_check(invalid, check)

    if F_fn is not None:
        new_traces, parents = _gather_from_F(state.traces,
                                             F_fn(key, weights, n), n)
    else:
        parents = parent_fn(key, weights, log_priorities)
        new_traces = _gather_traces(state.traces, parents)
    if is_sub:
        new_lw = _new_weights_sub(n, log_weights, log_priorities, parents,
                                  custom)
        # sub-states never touch the global LML (ref: src/resample.jl:185-187);
        # record parents as global indices so full-state ancestry holds
        src = state.scatter(traces=new_traces, log_weights=new_lw,
                            parents=state.idxs[parents])
        return src
    # fold LML before resampling (ref: src/resample.jl:178-182)
    new_lml = state.log_ml_est + logsumexp(log_weights) - jnp.log(float(n))
    new_lw = _new_weights_full(n, log_weights, log_priorities, parents,
                               custom)
    return ParticleFilterState(new_traces, new_lw, new_lml, parents)


def pf_multinomial_resample(key, state, priority_fn=None, check="warn"):
    with jax.named_scope("pf_resample"):
        return _resample_impl(key, state, priority_fn, check,
                              F_fn=multinomial_F)


def pf_residual_resample(key, state, priority_fn=None, check="warn"):
    with jax.named_scope("pf_resample"):
        return _resample_impl(key, state, priority_fn, check,
                              F_fn=residual_F)


def pf_stratified_resample(key, state, priority_fn=None, check="warn",
                           sort_particles: bool = True):
    with jax.named_scope("pf_resample"):
        if not sort_particles:
            return _resample_impl(key, state, priority_fn, check,
                                  F_fn=stratified_F)
        return _resample_impl(
            key, state, priority_fn, check,
            parent_fn=lambda k, w, lp: stratified_parents(
                k, w, log_priorities=lp))


def pf_systematic_resample(key, state, priority_fn=None, check="warn",
                           sort_particles: bool = False):
    with jax.named_scope("pf_resample"):
        if not sort_particles:
            return _resample_impl(key, state, priority_fn, check,
                                  F_fn=systematic_F)
        return _resample_impl(
            key, state, priority_fn, check,
            parent_fn=lambda k, w, lp: systematic_parents(
                k, w, log_priorities=lp, sort_particles=True))


_METHODS = {
    "multinomial": pf_multinomial_resample,
    "residual": pf_residual_resample,
    "stratified": pf_stratified_resample,
    "systematic": pf_systematic_resample,
}


def pf_resample(key, state, method: str = "multinomial", **kwargs):
    """Dispatch by method name (ref: src/resample.jl:19-30)."""
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(f"Resampling method {method!r} not recognized.")
    return fn(key, state, **kwargs)
