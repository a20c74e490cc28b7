"""Initialization tests (mirror of /root/reference/test/initialize.jl)."""

import math

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import genparticlefilters_tpu as g
from fixtures import (line_model, slope_choicemap, line_choicemap,
                      lp_normal, lp_bern)


@g.gen
def line_propose(_s):
    g.trace("slope", g.uniform_discrete(0, 0))


def make_outlier_propose(idxs):
    @g.gen
    def outlier_propose():
        for i in idxs:
            g.trace(("line", i, "outlier"), g.bernoulli(0.0))
    return outlier_propose


def test_initialize_default_proposal():
    # ref: test/initialize.jl:3-11
    state = g.pf_initialize(jr.key(0), line_model, (0,), g.choicemap(), 100)
    slopes = g.batched_choice(state, "slope")
    assert bool(jnp.all((slopes >= -2) & (slopes <= 2)))
    np.testing.assert_allclose(state.log_weights, 0.0, atol=1e-5)

    state = g.pf_initialize(jr.key(1), line_model, (1,), line_choicemap(1), 100)
    ys = g.batched_choice(state, ("line", 0, "y"))
    np.testing.assert_allclose(ys, 0.0, atol=1e-6)

    state = g.pf_initialize(jr.key(2), line_model, (10,), line_choicemap(10), 100)
    ys = g.batched_choice(state, ("line", 9, "y"))
    np.testing.assert_allclose(ys, 0.0, atol=1e-6)


def test_initialize_custom_proposal():
    # ref: test/initialize.jl:18-30 — weight = log(1/5) when slope proposed
    state = g.pf_initialize(jr.key(0), line_model, (0,), g.choicemap(), 100,
                            proposal=line_propose, proposal_args=(0,))
    slopes = g.batched_choice(state, "slope")
    np.testing.assert_array_equal(np.asarray(slopes), 0)
    np.testing.assert_allclose(state.log_weights, math.log(1 / 5), atol=1e-5)

    state = g.pf_initialize(jr.key(1), line_model, (1,), line_choicemap(1),
                            100, proposal=make_outlier_propose([0]),
                            proposal_args=())
    assert not bool(jnp.any(g.batched_choice(state, ("line", 0, "outlier"))))
    np.testing.assert_allclose(
        g.batched_choice(state, ("line", 0, "y")), 0.0, atol=1e-6)


def test_initialize_stratified():
    # ref: test/initialize.jl:39-64
    strata = [slope_choicemap(s) for s in range(-2, 3)]
    # contiguous: block b holds stratum b
    state = g.pf_initialize(jr.key(0), line_model, (0,), g.choicemap(), 100,
                            strata=strata, layout="contiguous")
    # stratum weight log(1/5) + log(n_strata) = 0 (ref: initialize.jl:45)
    np.testing.assert_allclose(state.log_weights, 0.0, atol=1e-5)
    slopes = np.asarray(g.batched_choice(state, "slope"))
    for b, s in enumerate(range(-2, 3)):
        assert (slopes[b * 20:(b + 1) * 20] == s).all()
    # interleaved: index k mod 5 holds stratum k
    state = g.pf_initialize(jr.key(1), line_model, (1,), line_choicemap(1),
                            100, strata=strata, layout="interleaved")
    slopes = np.asarray(g.batched_choice(state, "slope"))
    for k, s in enumerate(range(-2, 3)):
        assert (slopes[k::5] == s).all()
    np.testing.assert_allclose(
        g.batched_choice(state, ("line", 0, "y")), 0.0, atol=1e-6)


def test_initialize_stratified_custom_proposal():
    # ref: test/initialize.jl:66-93 — exact per-stratum weights
    strata = [slope_choicemap(s) for s in range(-2, 3)]
    state = g.pf_initialize(
        jr.key(0), line_model, (1,), line_choicemap(1), 100,
        proposal=make_outlier_propose([0]), proposal_args=(),
        strata=strata, layout="contiguous")
    slopes = np.asarray(g.batched_choice(state, "slope"))
    outl = np.asarray(g.batched_choice(state, ("line", 0, "outlier")))
    lw = np.asarray(state.log_weights)
    assert not outl.any()
    for b, s in enumerate(range(-2, 3)):
        blk = slice(b * 20, (b + 1) * 20)
        assert (slopes[blk] == s).all()
        # weight = log p(slope)+log p(outlier=F)+log p(y|...) - 0 + log 5
        #        = log(1/5) + log(0.9) + lp_normal + log 5
        expected = (lp_bern(False, 0.1) + lp_normal(0.0, s, 1.0))
        np.testing.assert_allclose(lw[blk], expected, atol=1e-4)


def test_initialize_dynamic_flag_accepted():
    # ref: test/initialize.jl:32-37 — no trace-type distinction here;
    # flag accepted for parity
    state = g.pf_initialize(jr.key(0), line_model, (0,), g.choicemap(), 10,
                            dynamic=True)
    assert state.n_particles == 10


def test_batched_vs_vmapped_interpretation():
    """The opt-in batched interpretation (GenFn.batch_safe) must produce a
    trace pytree STRUCTURALLY identical to the per-particle vmapped path
    (same treedef, same leaf shapes/dtypes) and statistically equivalent
    weights/posteriors."""
    import copy
    import jax

    assert getattr(line_model, "batch_safe", False)
    st_b = g.pf_initialize(jr.key(0), line_model, (5,), line_choicemap(5),
                           400)

    # force the vmapped fallback for the same model
    unmarked = copy.copy(line_model)
    unmarked.batch_safe = False
    st_v = g.pf_initialize(jr.key(0), unmarked, (5,), line_choicemap(5), 400)

    lb, tb = jax.tree_util.tree_flatten(st_b)
    lv, tv = jax.tree_util.tree_flatten(st_v)
    # treedefs differ only by the copied gen_fn identity in the static aux;
    # leaf count + per-leaf shapes/dtypes pin the structural contract
    assert len(lb) == len(lv)
    for a, b in zip(lb, lv):
        assert jnp.shape(a) == jnp.shape(b), (jnp.shape(a), jnp.shape(b))
        assert getattr(a, "dtype", None) == getattr(b, "dtype", None)

    # same model, same constraints: weights must agree in distribution —
    # with y fully constrained the weight is logpdf(slope)+Σ logpdf terms,
    # and the slope posterior must match across paths
    for addr in ["slope"]:
        pb = {k: v for k, v in g.proportionmap(st_b, addr).items()}
        pv = {k: v for k, v in g.proportionmap(st_v, addr).items()}
        for k in set(pb) | set(pv):
            assert abs(pb.get(k, 0.0) - pv.get(k, 0.0)) < 0.15, (k, pb, pv)

    # batched update composes with vmapped-produced states and vice versa
    st2 = g.pf_update(jr.key(1), st_b, (6,), (g.Extend(1),),
                      line_choicemap(6), check=False)
    assert st2.n_particles == 400
