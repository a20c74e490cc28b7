"""TPU-native Generative Function Interface (GFI).

This is the from-scratch equivalent of the Gen.jl substrate the reference
builds on (imported at /root/reference/src/GenParticleFilters.jl:3-4): traces,
``simulate`` / ``generate`` / ``propose`` / ``assess`` / ``update`` /
``regenerate``, and accessors (``get_choices`` / ``get_args`` / ``get_retval``
/ ``get_score`` / ``get_gen_fn``).

Design inversion vs. the reference's substrate: a trace is a **fixed-shape
pytree** with a static address schema, every interpreter is a **pure jittable
function** of ``(key, args, constraints)``, and per-particle loops become
``jax.vmap`` over a leading particle axis. Models are written with the
``@gen`` decorator; random choices are made with ``trace(addr, dist)`` which
dispatches to the active interpreter through a Python-side handler stack
(resolved entirely at JAX trace time — zero runtime overhead).

Weight semantics (matching Gen's GFI contract):

- ``generate``:   weight = Σ log p(constrained choices | rest)
- ``update``:     weight = score_new − score_old − Σ log q(freshly sampled)
- ``regenerate``: weight = (score_new − Σ_sel lp_new) − (score_old − Σ_sel lp_old)

The internal protocol (``_update`` / ``_regenerate``) exposes the raw
(score, logq / selection-lp) pieces so masked combinators like
:class:`~.combinators.Unfold` can apply per-step active masks before summing
— this is how Gen's dynamic trace extension becomes static-shape masking.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import jax.random as jr

from .choicemap import (ChoiceMap, Entry, Selection, EMPTY, NONE)
from .distributions import Distribution

__all__ = [
    "Trace", "GenFn", "DynamicGenFn", "gen", "trace",
    "NoChange", "UnknownChange", "Extend",
    "simulate", "generate", "propose", "assess", "update", "regenerate",
    "get_choices", "get_args", "get_retval", "get_score", "get_gen_fn",
]


# ---------------------------------------------------------------------------
# Argdiffs (API-parity sentinels; interpreters re-execute vectorized, so
# diffs are accepted for compatibility with the reference's call signatures,
# e.g. /root/reference/src/update.jl:12, but carry no information)
# ---------------------------------------------------------------------------

class NoChange:
    def __repr__(self):
        return "NoChange()"


class UnknownChange:
    def __repr__(self):
        return "UnknownChange()"


class Extend:
    """Argdiff for a combinator length argument: a static promise that the
    new length equals the old plus ``k`` and that constraints only target
    the newly activated steps. Unlocks the O(1)-per-step incremental
    extension path in :class:`~.combinators.Unfold` (the TPU equivalent of
    Gen's incremental computation on ``Unfold`` traces, which the reference
    relies on at /root/reference/src/update.jl:16-17).

    When the Unfold is nested inside a wrapping ``@gen`` model, name it:
    ``Extend(1, at="line")`` — the promise then reaches exactly that
    sub-call (other sub-generative-functions are updated normally). A bare
    ``Extend(k)`` inside a wrapping model with a *single* gf sub-call also
    reaches it; with several sub-calls an address is required."""

    __slots__ = ("k", "at")

    def __init__(self, k: int = 1, at=None):
        self.k = int(k)
        self.at = at

    def __repr__(self):
        return (f"Extend({self.k})" if self.at is None
                else f"Extend({self.k}, at={self.at!r})")


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class Trace:
    """An execution record: gen_fn (static), args, retval, score, and a
    gen_fn-specific ``inner`` payload holding the choices (sites and
    sub-traces); per-site scores are recomputed on demand, never stored."""

    __slots__ = ("gen_fn", "args", "retval", "score", "inner")

    def __init__(self, gen_fn, args, retval, score, inner):
        self.gen_fn = gen_fn
        self.args = args
        self.retval = retval
        self.score = score
        self.inner = inner

    def tree_flatten(self):
        return (self.args, self.retval, self.score, self.inner), self.gen_fn

    @classmethod
    def tree_unflatten(cls, gen_fn, children):
        return cls(gen_fn, *children)

    # Gen-style accessors (spec: /root/reference/SURVEY — L0 surface)
    def get_choices(self) -> ChoiceMap:
        return self.gen_fn.trace_choices(self)

    def get_args(self):
        return self.args

    def get_retval(self):
        # gen fns with packed storage (Unfold) materialize on demand
        return self.gen_fn.trace_retval(self)

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def __getitem__(self, addr):
        """Query a choice value by (possibly hierarchical) address."""
        return self.get_choices()[addr]


# ---------------------------------------------------------------------------
# GenFn base
# ---------------------------------------------------------------------------

class GenFn:
    """Base class for generative functions."""

    #: opt-in marker for BATCHED interpretation (see
    #: ``batched_interpretation``): set True only when the body is
    #: *batch-polymorphic* — every array it manipulates may silently carry a
    #: leading particle axis, so positional indexing like ``x[idx]`` (which
    #: would gather the particle axis) must be written as
    #: ``jnp.take_along_axis`` / elementwise ops. Unmarked functions always
    #: run per-particle under vmap (slower: ~0.1 ms/step of per-particle
    #: PRNG key chains at N=100K, scripts/rng_cost.py — but safe for any
    #: body). Combinators delegate to their inner function.
    batch_safe: bool = False

    # -- public GFI -------------------------------------------------------
    def simulate(self, key, args) -> Trace:
        raise NotImplementedError

    def generate(self, key, args, constraints: ChoiceMap = EMPTY
                 ) -> Tuple[Trace, jax.Array]:
        raise NotImplementedError

    def propose(self, key, args):
        tr = self.simulate(key, args)
        return tr.get_choices(), tr.score, tr.get_retval()

    def assess(self, args, choices: ChoiceMap):
        raise NotImplementedError

    def update(self, key, tr: Trace, new_args, argdiffs, constraints: ChoiceMap):
        new_tr, logq, discard = self._update(key, tr, new_args, constraints,
                                             argdiffs=argdiffs)
        weight = new_tr.score - tr.score - logq
        return new_tr, weight, UnknownChange(), discard

    def regenerate(self, key, tr: Trace, new_args, argdiffs,
                   selection: Selection, window: int | None = None):
        new_tr, sel_new, sel_old = self._regenerate(
            key, tr, new_args, selection, window=window)
        weight = (new_tr.score - sel_new) - (tr.score - sel_old)
        return new_tr, weight

    def regenerate_delta(self, key, tr: Trace, new_args, argdiffs,
                         selection: Selection, window: int | None = None):
        """Like :meth:`regenerate`, but returns ``(delta, weight)`` where
        ``delta`` is applied later with :meth:`apply_regenerate_delta` under
        an accept mask — this lets MH kernels avoid materializing a full
        rejected trace and a whole-trace select (the dominant cost of
        windowed rejuvenation on stacked combinator traces). Default delta
        = the full new trace."""
        return self.regenerate(key, tr, new_args, argdiffs, selection,
                               window=window)

    def apply_regenerate_delta(self, tr: Trace, delta, accept):
        """Produce the accepted-or-original trace from a regenerate delta.
        Default: structure-aware elementwise select between the two full
        traces (:meth:`select_trace`)."""
        return self.select_trace(accept, delta, tr)

    def select_trace(self, accept, new_tr: Trace, old_tr: Trace) -> Trace:
        """``where(accept, new, old)`` over two traces of this gen fn with
        layout knowledge: stored args pass through from ``new_tr``
        unselected (accept/reject kernels never change args, and selecting
        them would batch values the layout contract keeps shared across
        particles — see :meth:`trace_axes`). Sub-traces recurse through
        their own gen fn."""
        return Trace(self, new_tr.args,
                     select_batched(accept, new_tr.retval, old_tr.retval),
                     select_batched(accept, new_tr.score, old_tr.score),
                     select_batched(accept, new_tr.inner, old_tr.inner))

    # -- internal protocol (used by masked combinators) -------------------
    def _update(self, key, tr, new_args, constraints, argdiffs=None):
        """Returns (new_trace, logq_fresh, discard)."""
        raise NotImplementedError

    def _regenerate(self, key, tr, new_args, selection, window=None,
                    old_args=None, need_sel_old=True):
        """Returns (new_trace, sel_lp_new, sel_lp_old). ``window`` is an
        optional static promise that the selection only touches the last
        ``window`` active steps of a combinator (enables O(window)
        rejuvenation). ``old_args`` are the args the OLD trace was produced
        under (needed to recompute its selected log-probs); ``None`` falls
        back to the trace's stored args, then to ``new_args``. With
        ``need_sel_old=False`` the forced old-value pass is skipped and 0 is
        returned for sel_lp_old (callers that recompute it themselves, e.g.
        an enclosing _sel_logp recursion or a window path that needs the old
        step score anyway, avoid a duplicate execution)."""
        raise NotImplementedError

    def _sel_logp(self, tr, args, selection, window=None):
        """Force-execute with the old trace's values under ``args``; returns
        ``(retval, Σ selected∧present site log-probs, Σ all present site
        log-probs)`` — the exact reverse-proposal score and total old score
        regenerate's window paths need, recomputed instead of stored.

        ``window`` carries the same promise as in :meth:`_regenerate` (the
        selection only touches the last ``window`` active steps of any
        enclosed combinator); when given, combinators may restrict the forced
        pass to those steps, in which case the returned *score* term covers
        only the windowed steps (``sel_old`` stays exact)."""
        raise NotImplementedError

    # -- structure --------------------------------------------------------
    def trace_retval(self, tr: Trace):
        """The trace's return value. Default: the stored ``retval`` field;
        gen fns with packed step storage (:class:`~.combinators.Unfold`)
        override to materialize it from the packed matrix."""
        return tr.retval

    def retval_axes(self, tr: Trace, axis: int = 0):
        """Particle-axis spec for the MATERIALIZED ``get_retval()`` output
        (matches ``trace_axes(...).retval`` for plainly-stored retvals)."""
        return self.trace_axes(tr, axis).retval

    def trace_choices(self, tr: Trace) -> ChoiceMap:
        raise NotImplementedError

    def mask_trace(self, tr: Trace, m) -> Trace:
        """AND every choice's presence mask with ``m`` (traced bool ok)."""
        raise NotImplementedError

    def batch_stored_args(self, tr: Trace, batch: int) -> Trace:
        """Broadcast this trace's STORED args to the per-particle layout
        ``trace_axes`` promises at sub-call positions (batched
        interpretation only; see ``_Handler.record_sub``)."""
        return Trace(self, _batch_tree(tr.args, batch), tr.retval,
                     tr.score, tr.inner)

    # -- batching layout (see core/batching.py) ----------------------------
    def trace_axes(self, tr: Trace, axis: int = 0, args_shared: bool = False):
        """Particle-axis spec pytree for this trace when stacked across
        particles: same structure as ``tr``, each leaf an int axis position
        or ``None`` for values shared across particles.

        ``args_shared=True`` (the top-level SMC convention — every verb
        passes ONE args tuple for the whole particle set) marks the stored
        args as unbatched, so they are never broadcast into [N]-copies nor
        moved by resampling gathers. Sub-call traces inside a model keep
        batched args (they derive from per-particle upstream values).
        Combinators override to keep their stacked step storage time-major
        (particle axis after the static step axis). The particle count
        implied by the score leaf disambiguates SHARED leaves (stored once,
        no particle axis — see batching._leaf_axis)."""
        from .batching import gen_spec, _const_spec, spec_n
        n = spec_n(tr.score, axis)
        args_spec = (_const_spec(tr.args, None) if args_shared
                     else gen_spec(tr.args, axis, n))
        return Trace(self, args_spec, gen_spec(tr.retval, axis, n), axis,
                     gen_spec(tr.inner, axis, n))

    def trace_choice_axes(self, tr: Trace, axis: int = 0):
        """``{address: particle-axis}`` for every entry of
        ``trace_choices(tr)`` (the choicemap companion of
        :meth:`trace_axes`)."""
        return {k: axis for k in self.trace_choices(tr).entries}

    def __call__(self, *args):
        """Inside a @gen body, ``gf(args...)`` at an address via trace()."""
        raise TypeError(
            "Generative functions must be invoked via trace(addr, gf, args).")


def tree_select_shared(a, b) -> bool:
    """True when two tree leaves are interchangeable for an accept/reject
    select: the same object, or equal concrete scalars (a fresh
    ``asarray(t)`` of an unchanged combinator length, a Python int arg).
    Keeping such leaves un-selected preserves their unbatched layout under
    a per-particle accept mask."""
    if a is b:
        return True
    if isinstance(a, jax.core.Tracer) or isinstance(b, jax.core.Tracer):
        return False
    try:
        if jnp.ndim(a) != 0 or jnp.ndim(b) != 0:
            return False
        return bool(jnp.asarray(a) == jnp.asarray(b))
    except Exception:
        return False


def _where_lead(cond, a, b):
    """``where`` aligning ``cond`` against the LEADING axes of the operands
    (a per-particle [b] mask vs [b, ...] leaves; jnp.where alone would
    right-align). Scalar conds pass through unchanged.

    When the cond has MORE axes than the operands, the operands are SHARED
    across particles (e.g. a fully-constrained observation stored once);
    a per-particle select over a shared leaf is only reachable when both
    sides hold the same kept-old value, so it passes ``a`` through."""
    c = jnp.asarray(cond)
    nd = max(jnp.ndim(a), jnp.ndim(b))
    if c.ndim > nd:
        return jnp.asarray(a)
    if c.ndim and nd > c.ndim:
        c = c.reshape(c.shape + (1,) * (nd - c.ndim))
    return jnp.where(c, a, b)


def select_batched(accept, new, old):
    """``where(accept, new, old)`` over a container, dispatching nested
    traces to :meth:`GenFn.select_trace` (so combinator-shared leaves — the
    lockstep active length, stored args — keep their unbatched layout) and
    skipping leaves shared on both sides. ``accept`` may be a scalar (the
    vmapped per-particle path) or a per-particle [b] mask (batched
    interpretation), aligned against leading leaf axes."""
    def one(a, b):
        if isinstance(a, Trace):
            return a.gen_fn.select_trace(accept, a, b)
        if tree_select_shared(a, b):
            return a
        return _where_lead(accept, a, b)
    return jax.tree_util.tree_map(one, new, old,
                                  is_leaf=lambda x: isinstance(x, Trace))


# ---------------------------------------------------------------------------
# Handler machinery for the @gen DSL
# ---------------------------------------------------------------------------

_HANDLER_STACK = []
_BATCH_STACK: list = []


class batched_interpretation:
    """Context manager: run GFI interpreters in BATCHED mode over ``batch``
    particles — ONE interpretation with [batch]-leading site values, instead
    of ``vmap``-ing ``batch`` scalar interpretations over ``batch`` keys.

    Why this exists: under vmap, every particle pays a full counter-mode
    PRNG pass (~100 int-ops) per ``fold_in`` in its key chain — one per
    site plus per-step fold-ins. Batched, site keys
    are SCALAR fold-ins and each site draws its [batch] values in one
    counter-mode pass; the handler accumulators (score/weight/logq/sel_*)
    become per-particle [batch] vectors. The produced trace pytrees are
    layout-identical to the vmapped path (time-major stacked leaves,
    per-particle scores), so both paths interoperate freely — only the
    sampled randomness differs.

    Batchedness convention: a value or distribution parameter is treated
    as already carrying the particle axis iff its leading dim equals
    ``batch``; anything else is broadcast/shared. A genuinely unbatched
    array whose leading dim coincidentally equals the particle count is
    indistinguishable — avoid such shapes in batched models (or pick a
    different particle count).

    ``batched_interpretation(None)`` *suspends* an enclosing batched
    region (used by ``vmap_gfi``/``MapCombinator``, whose inner
    interpretations really are per-element).
    """

    def __init__(self, batch):
        self.batch = None if batch is None else int(batch)

    def __enter__(self):
        _BATCH_STACK.append(self.batch)
        return self.batch

    def __exit__(self, *exc):
        _BATCH_STACK.pop()
        return False


def current_batch():
    """The active batched-interpretation size, or None (per-particle)."""
    return _BATCH_STACK[-1] if _BATCH_STACK else None


def _bsum(x, batch):
    """Reduce a site log-prob into a handler accumulator: Σ over event dims
    keeping the leading particle axis in batched mode; shared (unbatched)
    values reduce to a scalar, which broadcasts into the [batch]
    accumulator."""
    x = jnp.asarray(x)
    if batch is not None and x.ndim >= 1 and x.shape[0] == batch:
        return x if x.ndim == 1 else jnp.sum(x.reshape(batch, -1), axis=1)
    return jnp.sum(x)


def _to_batch(v, batch):
    """Give ``v`` a leading particle axis in batched mode (shared values
    broadcast; leading-dim==batch values pass through)."""
    v = jnp.asarray(v)
    if batch is None or (v.ndim >= 1 and v.shape[0] == batch):
        return v
    return jnp.broadcast_to(v, (batch,) + v.shape)


def _batch_tree(x, batch):
    """:func:`_to_batch` over a container, leaving nested traces alone
    (their leaves already follow their own batched layout)."""
    if batch is None:
        return x
    return jax.tree_util.tree_map(
        lambda l: l if isinstance(l, Trace) else _to_batch(l, batch),
        x, is_leaf=lambda l: isinstance(l, Trace))


def trace(addr, dist_or_gf, args=None):
    """Make a random choice at ``addr`` inside a ``@gen`` function body.

    ``trace("x", normal(0., 1.))`` samples from a primitive distribution;
    ``trace("sub", other_gen_fn, (a, b))`` calls another generative function.
    Equivalent of Gen's ``{addr} ~ dist(...)`` syntax
    (/root/reference/test/runtests.jl:3-16).
    """
    if not _HANDLER_STACK:
        raise RuntimeError(
            "trace() called outside of a generative-function interpreter; "
            "models must be run via simulate/generate/assess/update/etc.")
    h = _HANDLER_STACK[-1]
    from .choicemap import normalize_address
    key = normalize_address(addr)
    if isinstance(dist_or_gf, Distribution):
        return h.dist_site(key, dist_or_gf)
    return h.call_site(key, dist_or_gf, tuple(args) if args is not None else ())


def _scope_path(cm_or_sel, path):
    out = cm_or_sel
    for comp in path:
        out = out.scope(comp)
    return out


def _masked_sum(lp, m, batch=None):
    """Σ lp over set mask bits; NaN/Inf-safe (masked slots contribute 0).
    In batched mode the leading particle axis survives (see :func:`_bsum`)."""
    if m is True:
        return _bsum(lp, batch)
    if m is False:
        return jnp.asarray(0.0, dtype=jnp.float32)
    lp = jnp.asarray(lp)
    mb = jnp.asarray(m, bool)
    shp = jnp.broadcast_shapes(lp.shape, mb.shape)
    return _bsum(jnp.where(jnp.broadcast_to(mb, shp),
                           jnp.broadcast_to(lp, shp), 0.0), batch)


def _broadcast_val(value, like):
    v = jnp.asarray(value)
    if v.dtype != like.dtype:
        v = v.astype(like.dtype)
    return jnp.broadcast_to(v, jnp.shape(like))


def _mask_to(m, like_shape):
    if m is True or m is False:
        return m
    mb = jnp.asarray(m, bool)
    extra = len(like_shape) - mb.ndim
    if extra > 0:
        mb = mb.reshape(mb.shape + (1,) * extra)
    return jnp.broadcast_to(mb, like_shape)


def _and_masks(a, b):
    if a is True:
        return b
    if b is True:
        return a
    if a is False or b is False:
        return False
    return jnp.logical_and(a, b)


def _not_mask(m):
    if m is True:
        return False
    if m is False:
        return True
    return jnp.logical_not(m)


class _Handler:
    """Shared accumulator state for all interpreters of the dynamic DSL.

    In batched mode (:class:`batched_interpretation`) every accumulator is
    a per-particle [batch] vector and :meth:`sample_site` draws [batch]
    values from ONE scalar site key."""

    def __init__(self, key):
        self.key = key
        self._ctr = 0
        self.batch = current_batch()
        self.sites: Dict[str, Entry] = {}
        self.subs: Dict[str, Trace] = {}
        self.score = self._zero()

    def _zero(self):
        if self.batch is None:
            return jnp.asarray(0.0, jnp.float32)
        return jnp.zeros((self.batch,), jnp.float32)

    def fresh_key(self):
        self._ctr += 1
        if self.key is None:
            raise RuntimeError("this interpreter does not sample; a site "
                               "required sampling but no key was provided")
        return jr.fold_in(self.key, self._ctr)

    def sample_site(self, dist):
        key = self.fresh_key()
        if self.batch is None:
            return dist.sample(key)
        return dist.sample_batched(key, self.batch)

    def record(self, addr, value, lp):
        if addr in self.sites or addr in self.subs:
            raise ValueError(f"duplicate address {addr!r} in @gen function")
        self.sites[addr] = Entry(value, True)
        self.score = self.score + _bsum(lp, self.batch)

    def record_sub(self, addr, sub_tr):
        if addr in self.sites or addr in self.subs:
            raise ValueError(f"duplicate address {addr!r} in @gen function")
        if self.batch is not None:
            # sub-call stored args sit at per-particle spec positions
            # (GenFn.trace_axes); give shared leaves the particle axis the
            # layout contract expects (Unfold keeps its lockstep t shared)
            sub_tr = sub_tr.gen_fn.batch_stored_args(sub_tr, self.batch)
        self.subs[addr] = sub_tr
        self.score = self.score + _bsum(sub_tr.score, self.batch)

    def inner(self):
        return {"sites": self.sites, "subs": self.subs}


class _SimulateHandler(_Handler):
    def dist_site(self, addr, dist):
        v = self.sample_site(dist)
        self.record(addr, v, dist.log_prob(v))
        return v

    def call_site(self, addr, gf, args):
        sub = gf.simulate(self.fresh_key(), args)
        self.record_sub(addr, sub)
        return sub.get_retval()


class _GenerateHandler(_Handler):
    def __init__(self, key, constraints: ChoiceMap):
        super().__init__(key)
        self.constraints = constraints
        self.weight = self._zero()

    def dist_site(self, addr, dist):
        e = self.constraints.resolve(addr)
        if e is None:
            v = self.sample_site(dist)
            self.record(addr, v, dist.log_prob(v))
            return v
        if e.mask is True:
            self.fresh_key()  # keep the per-site key stream stable
            # fully-constrained site: store the SHARED value (no particle
            # axis, no sampling) — observations are identical across
            # particles, so per-particle storage would only inflate the
            # bytes every resampling gather and extension write moves
            v = jnp.asarray(e.value)
            lp = dist.log_prob(v)
            self.weight = self.weight + _bsum(lp, self.batch)
            self.record(addr, v, lp)
            return v
        sampled = self.sample_site(dist)
        m = _mask_to(e.mask, jnp.shape(sampled))
        v = jnp.where(m, _broadcast_val(e.value, sampled), sampled)
        lp = dist.log_prob(v)
        self.weight = self.weight + _masked_sum(lp, m, self.batch)
        self.record(addr, v, lp)
        return v

    def call_site(self, addr, gf, args):
        sub, w = gf.generate(self.fresh_key(), args,
                             _scope_path(self.constraints, addr))
        self.weight = self.weight + w
        self.record_sub(addr, sub)
        return sub.get_retval()


class _AssessHandler(_Handler):
    def __init__(self, choices: ChoiceMap):
        super().__init__(None)
        self.choices = choices

    def dist_site(self, addr, dist):
        e = self.choices.resolve(addr)
        if e is None:
            raise ValueError(f"assess: missing choice at address {addr!r}")
        v = jnp.asarray(e.value)
        self.record(addr, v, dist.log_prob(v))
        return v

    def call_site(self, addr, gf, args):
        retval, score = gf.assess(args, _scope_path(self.choices, addr))
        # record as a pseudo-site score for completeness
        self.score = self.score + score
        return retval


class _UpdateHandler(_Handler):
    def __init__(self, key, old_inner, constraints: ChoiceMap,
                 argdiffs=None, sole_subcall=False):
        super().__init__(key)
        self.argdiffs = argdiffs
        self.sole_subcall = sole_subcall
        self.old_sites = old_inner["sites"]
        self.old_subs = old_inner["subs"]
        self.constraints = constraints
        self.logq = self._zero()
        self.discard: Dict[Tuple, Entry] = {}

    def dist_site(self, addr, dist):
        e = self.constraints.resolve(addr)
        old = self.old_sites.get(addr)

        # static fast paths — no sampling, SHARED storage preserved:
        if e is not None and e.mask is True:
            # fully constrained: value = constraint, logq/weight fresh-term
            # empty; old value (if any) is discarded where it was present
            self.fresh_key()  # keep the per-site key stream stable
            v = jnp.asarray(e.value)
            if old is not None and old.mask is not False:
                self.discard[addr] = Entry(old.value, old.mask)
            self.record(addr, v, dist.log_prob(v))
            return v
        if e is None and old is not None and old.mask is True:
            # pure reuse: keep the old value (rescored under new params);
            # no fresh mass, no discard
            self.fresh_key()
            v = jnp.asarray(old.value)
            self.record(addr, v, dist.log_prob(v))
            return v

        sampled = self.sample_site(dist)
        shape = jnp.shape(sampled)

        mc = False if e is None else _mask_to(e.mask, shape)
        mo = False if old is None else _mask_to(old.mask, shape)

        # value priority: constraint > old > fresh
        v = sampled
        if mo is not False:
            ov = _broadcast_val(old.value, sampled)
            v = ov if mo is True else jnp.where(mo, ov, v)
        if mc is not False:
            cv = _broadcast_val(e.value, sampled)
            v = cv if mc is True else jnp.where(mc, cv, v)

        lp = dist.log_prob(v)
        fresh = _and_masks(_not_mask(mc), _not_mask(mo))
        if fresh is not False:
            self.logq = self.logq + _masked_sum(lp, fresh, self.batch)
        overwritten = _and_masks(mc, mo)
        if overwritten is not False and old is not None:
            self.discard[addr] = Entry(old.value, overwritten)
        self.record(addr, v, lp)
        return v

    def call_site(self, addr, gf, args):
        old_sub = self.old_subs.get(addr)
        if old_sub is None:
            sub, w = gf.generate(self.fresh_key(), args,
                                 _scope_path(self.constraints, addr))
            # fresh sub-call: everything unconstrained was freshly sampled
            self.logq = self.logq + (sub.score - w)
            self.record_sub(addr, sub)
            return sub.get_retval()
        # propagate an Extend promise only to the sub-call it names
        # (Extend(k, at=addr)); a bare Extend reaches a sole gf sub-call
        sub_diffs = None
        if self.argdiffs and isinstance(self.argdiffs[0], Extend):
            ext = self.argdiffs[0]
            from .choicemap import normalize_address
            target_ok = (normalize_address(ext.at) == addr
                         if ext.at is not None else self.sole_subcall)
            if target_ok:
                sub_diffs = (ext,) + tuple(
                    NoChange() for _ in range(max(len(args) - 1, 0)))
        sub, logq, disc = gf._update(self.fresh_key(), old_sub, args,
                                     _scope_path(self.constraints, addr),
                                     argdiffs=sub_diffs)
        self.logq = self.logq + logq
        for k, v in disc.entries.items():
            self.discard[addr + k] = v
        self.record_sub(addr, sub)
        return sub.get_retval()


class _RegenerateHandler(_Handler):
    def __init__(self, key, old_inner, selection: Selection, window=None):
        super().__init__(key)
        self.window = window
        self.old_sites = old_inner["sites"]
        self.old_subs = old_inner["subs"]
        self.selection = selection
        self.sel_new = self._zero()

    def dist_site(self, addr, dist):
        old = self.old_sites.get(addr)
        sel = _scope_path(self.selection, addr).mask_at_leaf()
        if old is not None and sel is False and old.mask is True:
            # statically unselected, fully present: keep the old value
            # (SHARED storage preserved, no sampling pass)
            self.fresh_key()
            v = jnp.asarray(old.value)
            self.record(addr, v, dist.log_prob(v))
            return v
        sampled = self.sample_site(dist)
        shape = jnp.shape(sampled)
        if old is None:
            # structurally new site: treat as fresh (counts in both new score
            # and sel_new, canceling in the weight)
            lp = dist.log_prob(sampled)
            self.sel_new = self.sel_new + _bsum(lp, self.batch)
            self.record(addr, sampled, lp)
            return sampled
        mo = _mask_to(old.mask, shape)
        ms = _mask_to(sel, shape)
        ov = _broadcast_val(old.value, sampled)
        # selected (or old-absent) slots are resampled
        resample = _and_masks(_not_mask(_and_masks(mo, _not_mask(ms))), True)
        if resample is False:
            v = ov
        elif resample is True:
            v = sampled
        else:
            v = jnp.where(resample, sampled, ov)
        lp = dist.log_prob(v)
        if resample is not False:
            self.sel_new = self.sel_new + _masked_sum(lp, resample,
                                                      self.batch)
        self.record(addr, v, lp)
        return v

    def call_site(self, addr, gf, args):
        old_sub = self.old_subs.get(addr)
        if old_sub is None:
            sub = gf.simulate(self.fresh_key(), args)
            self.sel_new = self.sel_new + sub.score
            self.record_sub(addr, sub)
            return sub.get_retval()
        # sel_old of the sub-tree is NOT taken from the sub's return — the
        # enclosing _sel_logp pass recomputes it recursively under the OLD
        # upstream values (the sub's internal fallback would see new args)
        sub, sn, _ = gf._regenerate(self.fresh_key(), old_sub, args,
                                    _scope_path(self.selection, addr),
                                    window=self.window, need_sel_old=False)
        self.sel_new = self.sel_new + sn
        self.record_sub(addr, sub)
        return sub.get_retval()


class _SelLogpHandler(_Handler):
    """Re-execute a body FORCING the old trace's stored values, accumulating
    the selection-masked old log-probs Σ lp_old over selected∧present sites.

    This recovers regenerate's ``sel_old`` term (the reverse-proposal score,
    exact per-site lp under the old trace's own parameters) without storing
    per-site scores in every trace — on the object-motion fixture those were
    3 extra [N, T] f32 leaves, a third of all bytes the resampling gather and
    trace-extension writes have to move. Never samples (no key needed)."""

    def __init__(self, old_inner, selection: Selection, window=None):
        super().__init__(None)
        self.window = window
        self.old_sites = old_inner["sites"]
        self.old_subs = old_inner["subs"]
        self.selection = selection
        self.sel_old = self._zero()

    def dist_site(self, addr, dist):
        old = self.old_sites.get(addr)
        if old is None:
            # structurally new site (absent from the old trace): contributes
            # nothing to the old score or sel_old — mirror
            # _RegenerateHandler's fresh-sample branch with a deterministic
            # dummy value so the body can keep executing
            if self.batch is not None:
                return dist.sample_batched(jr.key(0), self.batch)
            return dist.sample(jr.key(0))
        v = jnp.asarray(old.value)
        mo = _mask_to(old.mask, jnp.shape(v))
        if mo is False:
            return v
        lp = dist.log_prob(v)
        self.score = self.score + _masked_sum(lp, mo, self.batch)
        sel = _scope_path(self.selection, addr).mask_at_leaf()
        m = _and_masks(_mask_to(sel, jnp.shape(v)), mo)
        if m is not False:
            self.sel_old = self.sel_old + _masked_sum(lp, m, self.batch)
        return v

    def call_site(self, addr, gf, args):
        old_sub = self.old_subs.get(addr)
        if old_sub is None:
            # structurally new sub-call: zero contribution (see dist_site)
            return gf.simulate(jr.key(0), args).get_retval()
        retval, so, sc = gf._sel_logp(old_sub, args,
                                      _scope_path(self.selection, addr),
                                      window=self.window)
        self.sel_old = self.sel_old + so
        self.score = self.score + sc
        return retval


# ---------------------------------------------------------------------------
# DynamicGenFn — the @gen DSL
# ---------------------------------------------------------------------------

class DynamicGenFn(GenFn):
    """A generative function defined by a Python body using :func:`trace`.

    The address set must be static (same sites on every execution); data-
    dependent *values* are fine (use ``jnp.where``), data-dependent *structure*
    is not — this is what makes traces fixed-shape pytrees and the whole GFI
    jit/vmap-compatible.
    """

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "gen_fn")

    def __repr__(self):
        return f"@gen {self.name}"

    def _run(self, handler, args):
        _HANDLER_STACK.append(handler)
        try:
            retval = self.fn(*args)
        finally:
            _HANDLER_STACK.pop()
        return retval

    def _mk_trace(self, args, retval, h: _Handler):
        return Trace(self, args, retval, h.score, h.inner())

    # -- GFI --------------------------------------------------------------
    def simulate(self, key, args):
        h = _SimulateHandler(key)
        retval = self._run(h, args)
        return self._mk_trace(args, retval, h)

    def generate(self, key, args, constraints: ChoiceMap = EMPTY):
        h = _GenerateHandler(key, constraints)
        retval = self._run(h, args)
        return self._mk_trace(args, retval, h), h.weight

    def assess(self, args, choices: ChoiceMap):
        h = _AssessHandler(choices)
        retval = self._run(h, args)
        return retval, h.score

    def _update(self, key, tr: Trace, new_args, constraints: ChoiceMap,
                argdiffs=None):
        h = _UpdateHandler(key, tr.inner, constraints, argdiffs=argdiffs,
                           sole_subcall=len(tr.inner["subs"]) == 1)
        retval = self._run(h, new_args)
        return self._mk_trace(new_args, retval, h), h.logq, ChoiceMap(h.discard)

    def _regenerate(self, key, tr: Trace, new_args, selection: Selection,
                    window=None, old_args=None, need_sel_old=True):
        h = _RegenerateHandler(key, tr.inner, selection, window=window)
        retval = self._run(h, new_args)
        if not need_sel_old:
            sel_old = jnp.asarray(0.0, jnp.float32)
        else:
            if old_args is None:
                old_args = tr.args if tr.args else new_args
            _, sel_old, _ = self._sel_logp(tr, old_args, selection,
                                           window=window)
        return self._mk_trace(new_args, retval, h), h.sel_new, sel_old

    def _sel_logp(self, tr: Trace, args, selection: Selection, window=None):
        h = _SelLogpHandler(tr.inner, selection, window=window)
        retval = self._run(h, args)
        return retval, h.sel_old, h.score

    # -- structure --------------------------------------------------------
    def trace_choices(self, tr: Trace) -> ChoiceMap:
        out: Dict[Tuple, Entry] = {}
        for addr, e in tr.inner["sites"].items():
            out[addr] = e
        for addr, sub in tr.inner["subs"].items():
            for k, v in sub.get_choices().entries.items():
                out[addr + k] = v
        return ChoiceMap(out)

    def mask_trace(self, tr: Trace, m) -> Trace:
        sites = {a: Entry(e.value, _and_masks(e.mask, m))
                 for a, e in tr.inner["sites"].items()}
        subs = {a: s.gen_fn.mask_trace(s, m)
                for a, s in tr.inner["subs"].items()}
        inner = {"sites": sites, "subs": subs}
        return Trace(tr.gen_fn, tr.args, tr.retval, tr.score, inner)

    def trace_choice_axes(self, tr: Trace, axis: int = 0):
        out = {a: axis for a in tr.inner["sites"]}
        for addr, sub in tr.inner["subs"].items():
            for k, ax in sub.gen_fn.trace_choice_axes(sub, axis).items():
                out[addr + k] = ax
        return out


def gen(fn: Callable) -> DynamicGenFn:
    """Decorator: turn a Python function using :func:`trace` into a
    generative function (equivalent of Gen's ``@gen``)."""
    return DynamicGenFn(fn)


# ---------------------------------------------------------------------------
# Module-level GFI verbs (Gen-style free functions)
# ---------------------------------------------------------------------------

def simulate(gf: GenFn, key, args):
    return gf.simulate(key, args)


def generate(gf: GenFn, key, args, constraints: ChoiceMap = EMPTY):
    return gf.generate(key, args, constraints)


def propose(gf: GenFn, key, args):
    return gf.propose(key, args)


def assess(gf: GenFn, args, choices: ChoiceMap):
    return gf.assess(args, choices)


def update(key, tr: Trace, new_args, argdiffs, constraints: ChoiceMap):
    return tr.gen_fn.update(key, tr, new_args, argdiffs, constraints)


def regenerate(key, tr: Trace, new_args, argdiffs, selection: Selection,
               window: int | None = None):
    return tr.gen_fn.regenerate(key, tr, new_args, argdiffs, selection,
                                window=window)


def get_choices(tr: Trace):
    return tr.get_choices()


def get_args(tr: Trace):
    return tr.get_args()


def get_retval(tr: Trace):
    return tr.get_retval()


def get_score(tr: Trace):
    return tr.get_score()


def get_gen_fn(tr: Trace):
    return tr.get_gen_fn()
