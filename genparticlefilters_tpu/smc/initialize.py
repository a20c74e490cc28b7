"""Particle filter initialization (ref: /root/reference/src/initialize.jl).

The reference's per-particle ``generate`` loop (src/initialize.jl:39-41)
becomes a single ``jax.vmap`` over split PRNG keys — one XLA computation over
the whole particle set, shardable along the particle axis. Variants mirror the reference's four methods:

- basic constrained generation (src/initialize.jl:31-44)
- custom proposal, weight = model − proposal (src/initialize.jl:46-62)
- stratified, each weight + log(n_strata) (src/initialize.jl:92-109)
- stratified + proposal (src/initialize.jl:111-129)

``dynamic=true`` (model-sequence SMC over differing trace types,
src/initialize.jl:27-29) has no TPU meaning — every model compiles its own
fixed trace schema and translators move states between schemas — so the
kwarg is accepted and ignored.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr

from ..core.choicemap import ChoiceMap, EMPTY
from ..core.gfi import GenFn
from ..utils.stratification import (stratum_assignment, stack_strata,
                                    gather_strata)
from .state import ParticleFilterState, pf_state

__all__ = ["pf_initialize"]


def pf_initialize(key, model: GenFn, model_args, observations: ChoiceMap,
                  n_particles: int, proposal: GenFn | None = None,
                  proposal_args=None, strata=None,
                  layout: str = "contiguous",
                  dynamic: bool = False) -> ParticleFilterState:
    """Initialize a particle filter with ``n_particles`` constrained traces."""
    del dynamic  # accepted for API parity; see module docstring
    if strata is not None:
        strata = list(strata)
        n_strata = len(strata)
        key, ka = jr.split(key)
        assign = stratum_assignment(ka, n_particles, n_strata, layout)
        stacked = stack_strata(strata)
        per_particle = gather_strata(stacked, assign)
        log_nk = jnp.log(float(n_strata))
    else:
        per_particle = None
        log_nk = 0.0

    p_args = tuple(proposal_args) if proposal_args is not None else ()

    if getattr(model, "batch_safe", False) and (
            proposal is None or getattr(proposal, "batch_safe", False)):
        # ONE batched interpretation over the particle axis: scalar site
        # keys, [N]-shaped draws in one counter-mode PRNG pass per site —
        # the vmapped per-particle key chains cost ~0.1 ms/step of pure key
        # arithmetic at N=100K (scripts/rng_cost.py). Opt-in: see
        # GenFn.batch_safe.
        from ..core.gfi import batched_interpretation
        with batched_interpretation(n_particles):
            if proposal is None:
                constraints = (observations if per_particle is None
                               else per_particle.merge(observations))
                traces, ws = model.generate(key, model_args, constraints)
                from .. import config as _config
                if _config.check_batched_layout and per_particle is None:
                    from ..core.batching import check_batched_layout
                    check_batched_layout(
                        traces,
                        lambda: model.generate(key, model_args,
                                               observations)[0],
                        n_particles, context="pf_initialize (batched)")
            else:
                k1, k2 = jr.split(key)
                prop_choices, prop_w, _ = proposal.propose(k1, p_args)
                base = (observations if per_particle is None
                        else per_particle.merge(observations))
                constraints = base.merge(prop_choices)
                traces, model_w = model.generate(k2, model_args, constraints)
                ws = model_w - prop_w
        return pf_state(traces, ws + log_nk)

    # per-particle fallback (any model body): vmap over split keys
    from ..core.batching import vmap_gfi
    keys = jr.split(key, n_particles)

    if proposal is None:
        if per_particle is None:
            def one(k):
                tr, w = model.generate(k, model_args, observations)
                return tr, w
            traces, ws = vmap_gfi(one, keys)
        else:
            def one(k, stratum):
                constraints = stratum.merge(observations)
                tr, w = model.generate(k, model_args, constraints)
                return tr, w
            traces, ws = vmap_gfi(one, keys, per_particle)
    else:
        if per_particle is None:
            def one(k):
                k1, k2 = jr.split(k)
                prop_choices, prop_w, _ = proposal.propose(k1, p_args)
                constraints = observations.merge(prop_choices)
                tr, model_w = model.generate(k2, model_args, constraints)
                return tr, model_w - prop_w
            traces, ws = vmap_gfi(one, keys)
        else:
            def one(k, stratum):
                k1, k2 = jr.split(k)
                prop_choices, prop_w, _ = proposal.propose(k1, p_args)
                constraints = stratum.merge(observations).merge(prop_choices)
                tr, model_w = model.generate(k2, model_args, constraints)
                return tr, model_w - prop_w
            traces, ws = vmap_gfi(one, keys, per_particle)

    return pf_state(traces, ws + log_nk)
