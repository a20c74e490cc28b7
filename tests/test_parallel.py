"""Sharding tests on an 8-virtual-device CPU mesh (SURVEY.md §4: the
reference's multi-node answer is mesh-on-CPU simulation)."""

import math

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import genparticlefilters_tpu as g
from genparticlefilters_tpu.parallel import (
    particle_mesh, shard_state, state_sharding,
    pf_resample_blockwise, pf_shuffle_blocks, pf_rotate_blocks,
    block_log_weight_imbalance)
from genparticlefilters_tpu.utils.weights import logsumexp
from fixtures import line_model, line_choicemap


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_blockwise_resample_semantics():
    # block totals preserved; ancestry stays within blocks; LML untouched
    state = g.pf_initialize(jr.key(0), line_model, (10,), line_choicemap(10),
                            128)
    out = pf_resample_blockwise(jr.key(1), state, 8, method="systematic")
    b = 128 // 8
    for k in range(8):
        blk = slice(k * b, (k + 1) * b)
        np.testing.assert_allclose(
            float(logsumexp(out.log_weights[blk])),
            float(logsumexp(state.log_weights[blk])), atol=1e-4)
        parents = np.asarray(out.parents[blk])
        assert ((parents >= k * b) & (parents < (k + 1) * b)).all()
    assert float(out.log_ml_est) == float(state.log_ml_est)
    np.testing.assert_allclose(float(g.log_ml_estimate(out)),
                               float(g.log_ml_estimate(state)), atol=1e-4)


def test_blockwise_priority_fn():
    state = g.pf_initialize(jr.key(0), line_model, (10,), line_choicemap(10),
                            64)
    out = pf_resample_blockwise(jr.key(1), state, 4, method="multinomial",
                                priority_fn=lambda w: w / 2)
    b = 64 // 4
    for k in range(4):
        blk = slice(k * b, (k + 1) * b)
        np.testing.assert_allclose(
            float(logsumexp(out.log_weights[blk])),
            float(logsumexp(state.log_weights[blk])), atol=1e-3)


def test_shuffle_and_rotate_preserve_multiset():
    state = g.pf_initialize(jr.key(0), line_model, (10,), line_choicemap(10),
                            64)
    for op in (lambda s: pf_shuffle_blocks(s, 8),
               lambda s: pf_rotate_blocks(s, 8, 3)):
        out = op(state)
        np.testing.assert_allclose(
            np.sort(np.asarray(out.log_weights)),
            np.sort(np.asarray(state.log_weights)), atol=1e-6)
        np.testing.assert_allclose(float(g.log_ml_estimate(out)),
                                   float(g.log_ml_estimate(state)),
                                   atol=1e-5)
    imb = float(block_log_weight_imbalance(state, 8))
    assert imb >= 0.0


def test_sharded_smc_step_executes():
    """Full SMC step (update + blockwise resample + diagnostics) jitted over
    an 8-device mesh with the particle axis sharded."""
    mesh = particle_mesh(jax.devices()[:8])
    n = 256
    state = g.pf_initialize(jr.key(0), line_model, (1,), line_choicemap(1), n)
    sharded = shard_state(state, mesh)
    shardings = state_sharding(mesh, state)

    @jax.jit
    def smc_step(key, s):
        k1, k2 = jr.split(key)
        s = g.pf_update(k1, s, (2,), (g.UnknownChange(),),
                        line_choicemap(2), check=False)
        s = pf_resample_blockwise(k2, s, 8, method="systematic")
        return s, g.effective_sample_size(s), g.log_ml_estimate(s)

    out, ess, lml = smc_step(jr.key(1), sharded)
    # semantics identical to the unsharded run with the same keys
    out2, ess2, lml2 = smc_step(jr.key(1), state)
    np.testing.assert_allclose(float(ess), float(ess2), rtol=1e-4)
    np.testing.assert_allclose(float(lml), float(lml2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.log_weights),
                               np.asarray(out2.log_weights), atol=1e-5)
    # output particle axis is still sharded across the 8 devices
    assert len(out.log_weights.sharding.device_set) == 8


def test_sharded_state_leaf_shardings():
    mesh = particle_mesh(jax.devices()[:8])
    state = g.pf_initialize(jr.key(0), line_model, (1,), line_choicemap(1),
                            64)
    sharded = shard_state(state, mesh)
    assert len(sharded.log_weights.sharding.device_set) == 8
    # scalar lml is replicated
    assert sharded.log_ml_est.sharding.is_fully_replicated


@pytest.mark.parametrize("method", ["multinomial", "residual", "stratified",
                                    "systematic"])
def test_global_resample_sharded_matches_unsharded(method):
    """Exact GLOBAL pf_resample executed on a mesh-sharded state (the
    all-to-all ancestry path) must equal the unsharded run bit for bit —
    the gather/weight semantics of /root/reference/src/resample.jl:59-65
    are sharding-invariant."""
    mesh = particle_mesh(jax.devices()[:8])
    n = 256
    state = g.pf_initialize(jr.key(0), line_model, (9,), line_choicemap(9),
                            n)
    sharded = shard_state(state, mesh)

    @jax.jit
    def step(key, s):
        s = g.pf_update(key, s, (10,), (g.UnknownChange(),),
                        line_choicemap(10), check=False)
        return g.pf_resample(jr.key(7), s, method, check=False)

    out_sharded = step(jr.key(1), sharded)
    out_plain = step(jr.key(1), state)
    np.testing.assert_array_equal(np.asarray(out_sharded.parents),
                                  np.asarray(out_plain.parents))
    np.testing.assert_array_equal(np.asarray(out_sharded.log_weights),
                                  np.asarray(out_plain.log_weights))
    np.testing.assert_allclose(float(out_sharded.log_ml_est),
                               float(out_plain.log_ml_est), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(out_sharded.traces),
                    jax.tree_util.tree_leaves(out_plain.traces)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # result still lives on the mesh
    assert len(out_sharded.log_weights.sharding.device_set) == 8


def test_distributed_lml_unbiasedness():
    """E[exp(LML_hat)] = Z for the COMPOSED distributed scheme — T steps of
    blockwise (shard-local) resampling + ring rotation — against the exact
    Kalman evidence (the estimator invariant of
    /root/reference/test/resample.jl:156-160, through the sharded path)."""
    from genparticlefilters_tpu.models.linear_gaussian import (
        LGParams, kalman_filter, make_lgssm, lg_obs_at_t, synthesize_lg_data)

    p = LGParams(a=0.7, q=0.6, r=0.5)
    T, n, n_blocks = 5, 256, 8
    y = synthesize_lg_data(jr.key(0), T, p)
    _, _, lml_exact = kalman_filter(y, p)
    mesh = particle_mesh(jax.devices()[:8])
    model = make_lgssm(T, p)
    x0 = jnp.asarray(0.0, jnp.float32)

    @jax.jit
    def dist_filter(key, s):
        def step(s, t):
            kt = jr.fold_in(key, t)
            kr, ku = jr.split(kt)
            s = pf_resample_blockwise(kr, s, n_blocks, method="systematic")
            s = pf_rotate_blocks(s, n_blocks, 1)
            s = g.pf_update(ku, s, (t + 1, x0),
                            (g.Extend(1), g.NoChange()), lg_obs_at_t(y, t),
                            check=False)
            return s, None
        s, _ = jax.lax.scan(step, s, jnp.arange(1, T, dtype=jnp.int32))
        return g.log_ml_estimate(s)

    lmls = []
    for seed in range(60):
        st = g.pf_initialize(jr.key(100 + seed), model, (1, x0),
                             lg_obs_at_t(y, 0), n)
        st = shard_state(st, mesh)
        lmls.append(float(dist_filter(jr.key(200 + seed), st)))
    z_hat = np.exp(np.asarray(lmls, np.float64) - float(lml_exact))
    stderr = z_hat.std() / np.sqrt(len(z_hat))
    assert abs(z_hat.mean() - 1.0) < 4 * stderr + 0.05, (z_hat.mean(), stderr)
