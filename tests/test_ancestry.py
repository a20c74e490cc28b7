"""The resampling building blocks on the XLA path: the packed ancestry
gather, parents from cumulative offspring counts, the merge count, the
offspring law of each method, and blockwise resampling on and off a mesh."""

import math

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import genparticlefilters_tpu as g
from genparticlefilters_tpu.smc import resample as rs
from genparticlefilters_tpu.parallel import (particle_mesh, shard_state,
                                             pf_resample_blockwise)
from genparticlefilters_tpu.utils.weights import logsumexp
from fixtures import line_model, line_choicemap

BITS = (-2**31, 2**31 - 1)


def _tree(key, n, d):
    """A plain pytree with particle axis 0: one [n, d] int32 leaf of random
    bit patterns plus f32, bool and uint32 leaves."""
    k1, k2, k3, k4 = jr.split(key, 4)
    return {"i": jr.randint(k1, (n, d), *BITS, dtype=jnp.int32),
            "f": jr.normal(k2, (n, 2)),
            "b": jr.bernoulli(k3, 0.5, (n, 3)),
            "u": jr.randint(k4, (n,), 0, 2**31 - 1).astype(jnp.uint32)}


def _assert_gathered(tree, out, parents):
    p = np.asarray(parents)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(tree[k])[p], err_msg=k)


def _np_parents(F, n_out):
    return np.searchsorted(np.asarray(F), np.arange(n_out), side="right")


# ---------------------------------------------------------------------------
# packed ancestry gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,d", [
    (2048, 512, 72), (1000, 1000, 43), (256, 256, 128), (2048, 2048, 53),
    (1000, 1000, 21), (513, 513, 96), (2048, 700, 29), (512, 512, 96),
    (1024, 512, 32)])
def test_gather_traces_exact(n, m, d):
    tree = _tree(jr.key(n + d), n, d)
    parents = jnp.sort(jr.randint(jr.key(m), (m,), 0, n, dtype=jnp.int32))
    _assert_gathered(tree, rs._gather_traces(tree, parents), parents)


@pytest.mark.parametrize("n,d", [(2048, 72), (1000, 43), (512, 96),
                                 (2048, 53), (1000, 21), (513, 96)])
def test_gather_from_F(n, d):
    tree = _tree(jr.key(d), n, d)
    w = jax.nn.softmax(2.0 * jr.normal(jr.key(n), (n,)))
    F = rs.systematic_F(jr.key(1), w)
    out, parents = rs._gather_from_F(tree, F, n)
    np.testing.assert_array_equal(np.asarray(parents), _np_parents(F, n))
    _assert_gathered(tree, out, parents)


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint32", "bool"])
def test_gather_keeps_extreme_bit_patterns(dtype):
    n = 16
    if dtype == "float32":
        vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                         3.4028235e38] * 2, np.float32)
        vals.view(np.int32)[4] = 0x7FC12345  # NaN with a payload
    elif dtype == "int32":
        vals = np.array([0, -1, 2**31 - 1, -2**31, 12345, -12345, 65536,
                         -65536] * 2, np.int32)
    elif dtype == "uint32":
        vals = np.array([0, 1, 2**32 - 1, 2**31, 2**31 - 1, 7, 2**16,
                         2**24 + 1] * 2, np.uint32)
    else:
        vals = np.array([True, False] * 8)
    parents = jnp.asarray(np.arange(n)[::-1].copy(), jnp.int32)
    out = rs._gather_traces({"x": jnp.asarray(vals)}, parents)["x"]
    want = vals[::-1]
    if dtype == "float32":
        np.testing.assert_array_equal(np.asarray(out).view(np.int32),
                                      want.view(np.int32))
    else:
        np.testing.assert_array_equal(np.asarray(out), want)


@pytest.mark.parametrize("n_out_factor", [1.0, 0.5, 2.0])
def test_gather_wide_pack(n_out_factor):
    # packs wider than 1022 rows take the same single gather
    n = 512
    n_out = int(n * n_out_factor)
    tree = {"wide": jr.randint(jr.key(0), (n, 1100), *BITS, dtype=jnp.int32),
            "f": jr.normal(jr.key(1), (n, 50))}
    w = jax.nn.softmax(jr.normal(jr.key(2), (n,)))
    F = rs.multinomial_F(jr.key(3), w, n_out)
    out, parents = rs._gather_from_F(tree, F, n_out)
    assert parents.shape == (n_out,)
    _assert_gathered(tree, out, parents)


# ---------------------------------------------------------------------------
# degenerate weights: every method puts all offspring on the one particle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", [0, 777, 1023])
@pytest.mark.parametrize("F_fn", [rs.systematic_F, rs.stratified_F,
                                  rs.multinomial_F, rs.residual_F],
                         ids=["systematic", "stratified", "multinomial",
                              "residual"])
def test_degenerate_weights(F_fn, where):
    n = 1024
    w = jnp.zeros((n,)).at[where].set(1.0)
    F = F_fn(jr.key(where), w, n)
    tree = _tree(jr.key(5), n, 4)
    out, parents = rs._gather_from_F(tree, F, n)
    np.testing.assert_array_equal(np.asarray(parents), np.full(n, where))
    _assert_gathered(tree, out, parents)


# ---------------------------------------------------------------------------
# merge count == searchsorted(u, c, side="right")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(100, 100), (1000, 1000), (2048, 1024),
                                 (1000, 2000), (777, 513), (4096, 4096)])
def test_merge_count_matches_searchsorted(n, m):
    c = jnp.cumsum(jr.dirichlet(jr.key(n), jnp.ones(n) * 0.5))
    c = c / c[-1]
    u = jnp.sort(jr.uniform(jr.key(m), (m,)))
    np.testing.assert_array_equal(
        np.asarray(rs._merge_count(c, u)),
        np.searchsorted(np.asarray(u), np.asarray(c), side="right"))


def _merge_case(name):
    n = 512
    c = np.cumsum(np.asarray(jr.dirichlet(jr.key(1), jnp.ones(n)),
                             np.float64)).astype(np.float32)
    c /= c[-1]
    u = np.sort(np.asarray(jr.uniform(jr.key(2), (n,)), np.float32))
    if name == "query_u_zero":
        u[:3] = 0.0
    elif name == "ties":
        u[::7] = c[np.arange(0, n, 7)]  # u == c exactly
        u = np.sort(u)
    elif name == "zero_weights":
        c[10:40] = c[9]  # repeated cumulative weights
    elif name == "padding":
        u[n // 2:] = 1.75  # residual's padding above every c
    elif name == "all_equal":
        u[:] = c[n // 3]
    return c, u


@pytest.mark.parametrize("name", ["query_u_zero", "ties", "zero_weights",
                                  "padding", "all_equal"])
def test_merge_count_edge_cases(name):
    c, u = _merge_case(name)
    np.testing.assert_array_equal(
        np.asarray(rs._merge_count(jnp.asarray(c), jnp.asarray(u))),
        np.searchsorted(u, c, side="right"))


# ---------------------------------------------------------------------------
# resizing in both directions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(2048, 1024), (1000, 2000), (513, 513),
                                 (600, 1200), (2048, 2048)])
@pytest.mark.parametrize("F_fn", [rs.multinomial_F, rs.residual_F],
                         ids=["multinomial", "residual"])
def test_resize_gather(F_fn, n, m):
    w = jr.dirichlet(jr.key(n + m), jnp.ones(n) * 0.5)
    F = F_fn(jr.key(3), w, m)
    assert int(F[-1]) == m and bool(jnp.all(jnp.diff(F) >= 0))
    tree = _tree(jr.key(4), n, 23)
    out, parents = rs._gather_from_F(tree, F, m)
    p = np.asarray(parents)
    np.testing.assert_array_equal(p, _np_parents(F, m))
    assert p.min() >= 0 and p.max() < n and (np.diff(p) >= 0).all()
    _assert_gathered(tree, out, parents)
    if F_fn is rs.residual_F:
        counts = np.bincount(p, minlength=n)
        assert (counts >= np.floor(m * np.asarray(w, np.float64)
                                   - 1e-3)).all()


# ---------------------------------------------------------------------------
# offspring laws per method
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial", "residual"])
def test_offspring_law(method, n):
    F_fn = {"systematic": rs.systematic_F, "stratified": rs.stratified_F,
            "multinomial": rs.multinomial_F, "residual": rs.residual_F}[method]
    for i in range(10):
        w = jr.dirichlet(jr.fold_in(jr.key(n), i), jnp.ones(n) * 0.4)
        p = np.asarray(rs._F_to_parents(F_fn(jr.fold_in(jr.key(7), i), w, n),
                                        n))
        assert (np.diff(p) >= 0).all() and p.min() >= 0 and p.max() < n
        counts = np.bincount(p, minlength=n)
        assert counts.sum() == n
        nw = n * np.asarray(w, np.float64)
        if method == "systematic":
            assert (np.abs(counts - nw) < 1.0 + 1e-4).all()
        elif method == "stratified":
            assert (np.abs(counts - nw) < 2.0 + 1e-4).all()
        elif method == "residual":
            assert (counts >= np.floor(nw - 1e-4)).all()


# ---------------------------------------------------------------------------
# blockwise resampling over K blocks, with and without a sharded state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def line_state():
    return g.pf_initialize(jr.key(0), line_model, (10,), line_choicemap(10),
                           840)


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "mesh8"])
@pytest.mark.parametrize("K", [3, 5, 7, 12])
def test_blockwise_resample_blocks(line_state, K, sharded):
    n = line_state.n_particles
    b = n // K
    step = jax.jit(lambda k, s: pf_resample_blockwise(k, s, K,
                                                      method="multinomial"))
    out = step(jr.key(K), line_state)
    if sharded:
        mesh = particle_mesh(jax.devices()[:8])
        out_m = step(jr.key(K), shard_state(line_state, mesh))
        assert len(out_m.log_weights.sharding.device_set) == 8
        np.testing.assert_array_equal(np.asarray(out_m.parents),
                                      np.asarray(out.parents))
        np.testing.assert_allclose(np.asarray(out_m.log_weights),
                                   np.asarray(out.log_weights), atol=1e-6)
        out = out_m
    parents = np.asarray(out.parents)
    for k in range(K):
        blk = slice(k * b, (k + 1) * b)
        assert ((parents[blk] >= k * b) & (parents[blk] < (k + 1) * b)).all()
        np.testing.assert_allclose(
            float(logsumexp(out.log_weights[blk])),
            float(logsumexp(line_state.log_weights[blk])), atol=1e-4)
    from genparticlefilters_tpu.core.batching import tree_take
    want = tree_take(line_state.traces, out.parents)
    for a, c in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(out.traces)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    assert math.isclose(float(out.log_ml_est), float(line_state.log_ml_est))


@pytest.mark.parametrize("n", [100, 4096, 5000, 100_001])
def test_blocked_scans_match_xla(n):
    # _cumsum1/_cummax1 (blocked [n/512, 512] scans) must agree with the
    # XLA ops: exactly for int32, and within reordering roundoff for f32 —
    # with monotone enforcement preserved
    xi = jr.randint(jr.key(1), (n,), -50, 50, jnp.int32)
    np.testing.assert_array_equal(np.asarray(rs._cumsum1(xi)),
                                  np.cumsum(np.asarray(xi)))
    np.testing.assert_array_equal(np.asarray(rs._cummax1(xi)),
                                  np.maximum.accumulate(np.asarray(xi)))
    xf = jr.uniform(jr.key(2), (n,), jnp.float32)
    np.testing.assert_allclose(np.asarray(rs._cumsum1(xf)),
                               np.cumsum(np.asarray(xf, np.float64)),
                               rtol=2e-6, atol=2e-3)
    cm = np.asarray(rs._cummax1(rs._cumsum1(xf)))
    assert (np.diff(cm) >= 0).all()
