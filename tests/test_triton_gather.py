"""The Triton resampling-gather kernel (``ops/triton_gather.py``) in the
Pallas interpreter on the CPU, the choice of gather path, and the kernel
compiled for the card (marked ``gpu``)."""

import functools

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from genparticlefilters_tpu.ops import triton_gather
from genparticlefilters_tpu.smc import resample as rs

BITS = (-2**31, 2**31 - 1)


def _reference(big, F, n_out):
    parents = rs._F_to_parents(F, n_out)
    return jnp.take(big, parents, axis=1), parents


def _check(big, F, n_out):
    out, parents = triton_gather.resample_gather(big, F, n_out,
                                                 interpret=True)
    want, want_parents = _reference(big, F, n_out)
    np.testing.assert_array_equal(np.asarray(parents),
                                  np.asarray(want_parents))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))


@pytest.mark.parametrize("n,n_out,d", [
    (2048, 2048, 53), (1000, 1000, 21), (513, 513, 96), (3000, 1500, 5),
    (700, 2100, 2), (1024, 1024, 1), (1500, 1500, 1100)])
def test_kernel_matches_xla(n, n_out, d):
    big = jr.randint(jr.key(d), (d, n), *BITS, dtype=jnp.int32)
    w = jax.nn.softmax(2.0 * jr.normal(jr.key(n), (n,)))
    _check(big, rs.systematic_F(jr.key(1), w, n_out), n_out)


@pytest.mark.parametrize("F_fn", [rs.systematic_F, rs.stratified_F,
                                  rs.multinomial_F, rs.residual_F],
                         ids=["systematic", "stratified", "multinomial",
                              "residual"])
def test_kernel_every_method(F_fn):
    n, d = 1500, 7
    big = jr.randint(jr.key(3), (d, n), *BITS, dtype=jnp.int32)
    w = jr.dirichlet(jr.key(4), jnp.ones(n) * 0.5).at[5:9].set(0.0)
    _check(big, F_fn(jr.key(5), w / w.sum(), n), n)


@pytest.mark.parametrize("where", [0, 777, 1023])
def test_kernel_degenerate(where):
    n, d = 1024, 6
    big = jr.randint(jr.key(where), (d, n), *BITS, dtype=jnp.int32)
    F = jnp.where(jnp.arange(n) >= where, n, 0).astype(jnp.int32)
    out, parents = triton_gather.resample_gather(big, F, n, interpret=True)
    np.testing.assert_array_equal(np.asarray(parents), np.full(n, where))
    np.testing.assert_array_equal(
        np.asarray(out), np.repeat(np.asarray(big)[:, where:where + 1], n, 1))


@pytest.mark.parametrize("n,n_out", [(1025, 1025), (4096, 1)])
def test_kernel_block_edges(n, n_out):
    # one column past a block boundary; a single output column
    d = 9
    big = jr.randint(jr.key(8), (d, n), *BITS, dtype=jnp.int32)
    w = jax.nn.softmax(jr.normal(jr.key(9), (n,)))
    _check(big, rs.multinomial_F(jr.key(10), w, n_out), n_out)


def test_choice_is_xla_on_cpu():
    assert jax.default_backend() == "cpu"
    assert rs._use_triton_gather() is False


@pytest.mark.parametrize("backend,count,want", [
    ("gpu", 1, True), ("gpu", 4, False), ("cpu", 1, False)])
def test_choice_rule(monkeypatch, backend, count, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jax, "device_count", lambda: count)
    assert rs._use_triton_gather() is want


@pytest.mark.parametrize("n_out", [640, 320, 1280])
def test_gather_from_F_through_kernel(monkeypatch, n_out):
    # the wrapper's packing, kernel call and unpacking, with the kernel
    # interpreted, against the XLA path on a real filter state
    import genparticlefilters_tpu as g
    from fixtures import line_model, line_choicemap
    state = g.pf_initialize(jr.key(0), line_model, (10,), line_choicemap(10),
                            640)
    w = jax.nn.softmax(state.log_weights)
    F = rs.residual_F(jr.key(1), w, n_out)
    want, want_parents = rs._gather_from_F(state.traces, F, n_out)
    monkeypatch.setattr(rs, "_use_triton_gather", lambda: True)
    monkeypatch.setattr(
        triton_gather, "resample_gather",
        functools.partial(triton_gather.resample_gather, interpret=True))
    got, parents = rs._gather_from_F(state.traces, F, n_out)
    np.testing.assert_array_equal(np.asarray(parents),
                                  np.asarray(want_parents))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
@pytest.mark.parametrize("d,n_out", [(43, 1_000_000), (161, 1_000_000),
                                     (43, 500_000)])
def test_kernel_on_card(gpu, d, n_out):
    n = 1_000_000
    big = jr.randint(jr.key(d), (d, n), *BITS, dtype=jnp.int32)
    w = jax.nn.softmax(2.0 * jr.normal(jr.key(1), (n,)))
    F = rs.multinomial_F(jr.key(2), w, n_out)
    out, parents = triton_gather.resample_gather(big, F, n_out)
    want, want_parents = _reference(big, F, n_out)
    assert bool(jnp.array_equal(parents, want_parents))
    assert bool(jnp.array_equal(out, want))
