"""Utility + statistics tests (mirror of /root/reference/test/utils.jl and
test/statistics.jl)."""

import math

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import genparticlefilters_tpu as g
from genparticlefilters_tpu.utils.weights import (lognorm, softmax,
                                                  safe_softmax, logsumexp)
from fixtures import line_model, line_choicemap, slope_choicemap


def test_choiceproduct():
    # ref: src/utils.jl:84-98
    strata = g.choiceproduct(("a", [1, 2]), ("b", [3]))
    assert len(strata) == 2
    assert float(strata[0]["a"]) == 1 and float(strata[0]["b"]) == 3
    assert float(strata[1]["a"]) == 2
    strata = g.choiceproduct({"a": [1, 2], "b": [3, 4]})
    assert len(strata) == 4
    strata = g.choiceproduct(("slope", [-2, -1, 0, 1, 2]))
    assert len(strata) == 5


def test_softmax_family():
    vs = jnp.asarray([0.0, math.log(3.0)])
    np.testing.assert_allclose(softmax(vs), [0.25, 0.75], atol=1e-6)
    np.testing.assert_allclose(lognorm(vs),
                               [math.log(0.25), math.log(0.75)], atol=1e-6)
    # safe_softmax edge cases (ref: src/utils.jl:117-140)
    w, inv = safe_softmax(jnp.asarray([0.0, jnp.nan]))
    assert bool(inv) and bool(jnp.all(jnp.isnan(w)))
    w, inv = safe_softmax(jnp.asarray([-jnp.inf, -jnp.inf]))
    assert bool(inv)
    np.testing.assert_allclose(w, 0.5, atol=1e-6)
    w, inv = safe_softmax(jnp.asarray([0.0, 0.0]))
    assert not bool(inv)
    np.testing.assert_allclose(w, 0.5, atol=1e-6)


def test_ess_and_lml():
    state = g.pf_initialize(jr.key(0), line_model, (10,), line_choicemap(10),
                            100)
    lw = np.asarray(state.log_weights, np.float64)
    lnw = lw - (np.log(np.sum(np.exp(lw - lw.max()))) + lw.max())
    ess_expected = 1.0 / np.sum(np.exp(lnw) ** 2)
    np.testing.assert_allclose(float(g.effective_sample_size(state)),
                               ess_expected, rtol=1e-4)
    np.testing.assert_allclose(float(g.get_ess(state)), ess_expected,
                               rtol=1e-4)
    lml = float(g.log_ml_estimate(state))
    np.testing.assert_allclose(
        lml, float(logsumexp(state.log_weights)) - math.log(100), atol=1e-5)
    # sub-state LML (ref: src/utils.jl:174-178)
    sub = state[0:50]
    np.testing.assert_allclose(
        float(g.log_ml_estimate(sub)),
        float(logsumexp(state.log_weights[:50])) - math.log(50), atol=1e-5)


def test_sample_unweighted_traces():
    state = g.pf_initialize(jr.key(0), line_model, (0,), slope_choicemap(1),
                            20)
    traces = g.sample_unweighted_traces(jr.key(1), state, 7)
    # "slope" is fully constrained -> stored SHARED (no particle axis in the
    # raw trace storage; user-facing per-particle views broadcast)
    slopes = traces.get_choices()["slope"]
    assert jnp.shape(slopes) in ((), (7,))
    assert bool(jnp.all(slopes == 1))
    # an unconstrained per-step site keeps its per-sample axis
    outl = traces.get_choices()[("line", 0, "outlier")]
    assert jnp.shape(outl) == (7,)


def test_mean_var_proportionmap():
    # weighted stats over an address (ref: src/statistics.jl)
    state = g.pf_initialize(jr.key(0), line_model, (0,), g.choicemap(), 2000)
    m = float(g.mean(state, "slope"))
    v = float(g.var(state, "slope"))
    # uniform over {-2..2}: mean 0, var 2
    assert abs(m) < 0.15
    assert abs(v - 2.0) < 0.25
    pm = g.proportionmap(state, "slope")
    assert set(pm.keys()) == {-2, -1, 0, 1, 2}
    np.testing.assert_allclose(sum(pm.values()), 1.0, atol=1e-5)
    for p in pm.values():
        assert abs(p - 0.2) < 0.1
    # mapped-function variants (ref: src/statistics.jl:28-38)
    m2 = float(g.mean(state, "slope", lambda s: s * 2))
    np.testing.assert_allclose(m2, 2 * m, atol=1e-5)
    v2 = float(g.var(state, "slope", lambda s: s * 2))
    np.testing.assert_allclose(v2, 4 * v, rtol=1e-4)
    pm2 = g.proportionmap(state, "slope", lambda s: abs(s))
    assert set(pm2.keys()) == {0, 1, 2}


def test_weighted_mean_exact():
    state = g.pf_initialize(jr.key(0), line_model, (0,), g.choicemap(), 100)
    # force known weights
    lw = jnp.where(jnp.arange(100) < 50, 0.0, -jnp.inf)
    state = state.replace(log_weights=lw)
    slopes = np.asarray(g.batched_choice(state, "slope"), np.float64)
    np.testing.assert_allclose(float(g.mean(state, "slope")),
                               slopes[:50].mean(), atol=1e-4)


def test_stratified_assignment_layouts():
    from genparticlefilters_tpu.utils.stratification import stratum_assignment
    a = np.asarray(stratum_assignment(jr.key(0), 10, 3, "contiguous"))
    assert (a[:3] == 0).all() and (a[3:6] == 1).all() and (a[6:9] == 2).all()
    assert 0 <= a[9] <= 2  # random remainder
    a = np.asarray(stratum_assignment(jr.key(0), 10, 3, "interleaved"))
    assert (a[:9] == np.arange(9) % 3).all()


def test_checkpoint_roundtrip(tmp_path):
    from genparticlefilters_tpu.utils.checkpoint import (save_state,
                                                         restore_state)
    state = g.pf_initialize(jr.key(0), line_model, (3,), line_choicemap(3),
                            32)
    p = str(tmp_path / "ckpt")
    save_state(p, state)
    fresh = g.pf_initialize(jr.key(1), line_model, (3,), line_choicemap(3),
                            32)
    restored = restore_state(p, fresh)
    for a, b in zip(jnp.asarray(state.log_weights),
                    jnp.asarray(restored.log_weights)):
        assert float(a) == float(b)
    np.testing.assert_array_equal(
        np.asarray(g.batched_choice(state, "slope")),
        np.asarray(g.batched_choice(restored, "slope")))


def test_checkpoint_incompatible_raises(tmp_path):
    # a checkpoint restored onto a structure with a different particle
    # count / horizon must raise a clear error, never load leaves into
    # shifted slots
    import pytest
    from genparticlefilters_tpu.utils.checkpoint import (save_state,
                                                         restore_state)
    state = g.pf_initialize(jr.key(0), line_model, (3,), line_choicemap(3),
                            32)
    p = str(tmp_path / "ckpt")
    save_state(p, state)
    wrong_n = g.pf_initialize(jr.key(1), line_model, (3,), line_choicemap(3),
                              16)
    with pytest.raises(ValueError):
        restore_state(p, wrong_n)


def test_timer_waits_for_result():
    import jax.numpy as jnp
    from genparticlefilters_tpu.utils.profiling import Timer
    with Timer() as t:
        x = jnp.arange(1000.0).sum()
    assert t.elapsed >= 0.0
    t2 = Timer().__enter__()
    assert t2.stop(x) >= 0.0 and t2.elapsed is not None
