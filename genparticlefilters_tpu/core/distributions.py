"""TPU-native primitive distributions: pure jittable ``sample``/``log_prob`` pairs.

These play the role of Gen.jl's distribution library (the reference imports
them from Gen; see /root/reference/src/GenParticleFilters.jl:3 and usages like
``bernoulli``/``normal``/``uniform_discrete`` in /root/reference/test/runtests.jl:3-16).

Design: every distribution is a lightweight pytree whose parameters may be
traced JAX arrays, with ``sample(key) -> value`` and ``log_prob(value) -> f32``
both shape-polymorphic and free of Python control flow, so they vectorize
across the particle axis under ``jax.vmap`` and compile to fused elementwise kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import jax.random as jr
from jax.scipy import special as jsp_special

__all__ = [
    "Distribution",
    "Normal", "normal",
    "Bernoulli", "bernoulli",
    "UniformDiscrete", "uniform_discrete",
    "Uniform", "uniform",
    "Categorical", "categorical",
    "LabeledCategorical", "labeled_categorical",
    "Poisson", "poisson",
    "Gamma", "gamma",
    "Beta", "beta",
    "Exponential", "exponential",
    "Geometric", "geometric",
    "LogNormal", "lognormal",
    "Laplace", "laplace",
    "Cauchy", "cauchy",
    "StudentT", "student_t",
    "MvNormalDiag", "mvnormal_diag",
    "MvNormal", "mvnormal",
    "Delta", "delta",
    "Factor", "factor",
]


def _f(x):
    return jnp.asarray(x, dtype=jnp.float32)


class Distribution:
    """Base class for primitive distributions (pytree of parameters)."""

    #: shape of a single event, appended to the broadcast of parameter shapes
    event_ndim: int = 0

    def sample(self, key: jax.Array) -> jax.Array:
        raise NotImplementedError

    def sample_batched(self, key: jax.Array, b: int) -> jax.Array:
        """Draw with a leading particle axis of size ``b`` from ONE key —
        one counter-mode PRNG pass, instead of ``b`` per-particle key
        chains under vmap (see ``core.gfi.batched_interpretation``).

        Convention: params whose leading dim equals ``b`` already carry
        the particle axis (the common case: params computed from batched
        upstream state). Scalar-batch-shape params are broadcast to
        ``(b,) + shape`` — valid for every distribution here because
        ``sample`` derives its draw shape from the broadcast parameter
        shapes. Anything else falls back to a vmap of scalar draws
        (correct, slower)."""
        bs = tuple(self.batch_shape())
        if len(bs) >= 1 and bs[0] == b:
            return self.sample(key)
        if bs == ():
            bd = jax.tree_util.tree_map(
                lambda p: jnp.broadcast_to(jnp.asarray(p),
                                           (b,) + jnp.shape(p)), self)
            return bd.sample(key)
        import jax.random as _jr
        return jax.vmap(self.sample)(_jr.split(key, b))

    def log_prob(self, value: jax.Array) -> jax.Array:
        """Elementwise log density; reduced over event dims only."""
        raise NotImplementedError

    def batch_shape(self) -> tuple:
        raise NotImplementedError


def _dist(cls):
    """Register a distribution dataclass as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(d):
        return tuple(getattr(d, n) for n in fields), None

    def unflatten(_, children):
        return cls(*children)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_dist
class Normal(Distribution):
    loc: Any
    scale: Any

    def sample(self, key):
        loc, scale = _f(self.loc), _f(self.scale)
        shape = jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        return loc + scale * jr.normal(key, shape, dtype=jnp.float32)

    def log_prob(self, value):
        loc, scale = _f(self.loc), _f(self.scale)
        z = (_f(value) - loc) / scale
        return -0.5 * z * z - jnp.log(scale) - 0.5 * jnp.log(2.0 * jnp.pi)

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale))


@_dist
class Bernoulli(Distribution):
    p: Any

    def sample(self, key):
        p = _f(self.p)
        return jr.uniform(key, jnp.shape(p), dtype=jnp.float32) < p

    def log_prob(self, value):
        p = jnp.clip(_f(self.p), 1e-37, 1.0 - 1e-7)
        v = jnp.asarray(value)
        vb = v.astype(jnp.bool_)
        return jnp.where(vb, jnp.log(p), jnp.log1p(-p))

    def batch_shape(self):
        return jnp.shape(self.p)


@_dist
class UniformDiscrete(Distribution):
    """Uniform over integers ``lo..hi`` inclusive (Gen's ``uniform_discrete``)."""
    lo: Any
    hi: Any

    def sample(self, key):
        lo = jnp.asarray(self.lo, jnp.int32)
        hi = jnp.asarray(self.hi, jnp.int32)
        shape = jnp.broadcast_shapes(jnp.shape(lo), jnp.shape(hi))
        return jr.randint(key, shape, lo, hi + 1, dtype=jnp.int32)

    def log_prob(self, value):
        lo = jnp.asarray(self.lo, jnp.int32)
        hi = jnp.asarray(self.hi, jnp.int32)
        v = jnp.asarray(value, jnp.int32)
        n = _f(hi - lo + 1)
        in_support = (v >= lo) & (v <= hi)
        return jnp.where(in_support, -jnp.log(n), -jnp.inf)

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.lo), jnp.shape(self.hi))


@_dist
class Uniform(Distribution):
    lo: Any
    hi: Any

    def sample(self, key):
        lo, hi = _f(self.lo), _f(self.hi)
        shape = jnp.broadcast_shapes(jnp.shape(lo), jnp.shape(hi))
        return jr.uniform(key, shape, dtype=jnp.float32, minval=lo, maxval=hi)

    def log_prob(self, value):
        lo, hi = _f(self.lo), _f(self.hi)
        v = _f(value)
        in_support = (v >= lo) & (v <= hi)
        return jnp.where(in_support, -jnp.log(hi - lo), -jnp.inf)

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.lo), jnp.shape(self.hi))


@_dist
class Categorical(Distribution):
    """Categorical over ``0..K-1`` from unnormalized ``logits`` (last axis)."""
    logits: Any
    event_ndim = 0

    def sample(self, key):
        return jr.categorical(key, _f(self.logits), axis=-1).astype(jnp.int32)

    def log_prob(self, value):
        logits = _f(self.logits)
        logz = jsp_special.logsumexp(logits, axis=-1)
        v = jnp.asarray(value, jnp.int32)
        picked = jnp.take_along_axis(
            logits, v[..., None], axis=-1
        ).squeeze(-1)
        in_support = (v >= 0) & (v < logits.shape[-1])
        return jnp.where(in_support, picked - logz, -jnp.inf)

    def batch_shape(self):
        return jnp.shape(self.logits)[:-1]


@_dist
class LabeledCategorical(Distribution):
    """Categorical over a static array of ``labels`` with given ``probs``."""
    labels: Any
    probs: Any

    def sample(self, key):
        idx = jr.categorical(key, jnp.log(_f(self.probs)), axis=-1)
        labels = jnp.asarray(self.labels)
        if labels.ndim == jnp.ndim(self.probs) and labels.ndim > 1:
            # batched labels rows (e.g. broadcast by sample_batched)
            return jnp.take_along_axis(labels, idx[..., None],
                                       axis=-1)[..., 0]
        return labels[idx]

    def log_prob(self, value):
        labels = jnp.asarray(self.labels)
        probs = _f(self.probs)
        match = jnp.asarray(value)[..., None] == labels
        p = jnp.sum(jnp.where(match, probs, 0.0), axis=-1)
        return jnp.where(p > 0, jnp.log(jnp.maximum(p, 1e-37)), -jnp.inf)

    def batch_shape(self):
        return jnp.shape(self.probs)[:-1]


@_dist
class Poisson(Distribution):
    rate: Any

    def sample(self, key):
        return jr.poisson(key, _f(self.rate)).astype(jnp.int32)

    def log_prob(self, value):
        rate = _f(self.rate)
        v = _f(value)
        # guard 0*log(0) at (v=0, rate=0): P(0)=1 there
        vlog = jnp.where(v > 0, v * jnp.log(jnp.maximum(rate, 1e-37)), 0.0)
        lp = vlog - rate - jsp_special.gammaln(v + 1.0)
        return jnp.where(v >= 0, lp, -jnp.inf)

    def batch_shape(self):
        return jnp.shape(self.rate)


@_dist
class Gamma(Distribution):
    shape_: Any  # shape parameter alpha
    scale: Any

    def sample(self, key):
        a, s = _f(self.shape_), _f(self.scale)
        return jr.gamma(key, a, dtype=jnp.float32) * s

    def log_prob(self, value):
        a, s = _f(self.shape_), _f(self.scale)
        v = _f(value)
        lp = ((a - 1.0) * jnp.log(v) - v / s
              - jsp_special.gammaln(a) - a * jnp.log(s))
        return jnp.where(v > 0, lp, -jnp.inf)

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.shape_), jnp.shape(self.scale))


@_dist
class Beta(Distribution):
    a: Any
    b: Any

    def sample(self, key):
        return jr.beta(key, _f(self.a), _f(self.b), dtype=jnp.float32)

    def log_prob(self, value):
        a, b = _f(self.a), _f(self.b)
        v = _f(value)
        lp = ((a - 1.0) * jnp.log(v) + (b - 1.0) * jnp.log1p(-v)
              - jsp_special.betaln(a, b))
        return jnp.where((v > 0) & (v < 1), lp, -jnp.inf)

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.a), jnp.shape(self.b))


@_dist
class Exponential(Distribution):
    rate: Any

    def sample(self, key):
        r = _f(self.rate)
        return jr.exponential(key, jnp.shape(r), dtype=jnp.float32) / r

    def log_prob(self, value):
        r = _f(self.rate)
        v = _f(value)
        return jnp.where(v >= 0, jnp.log(r) - r * v, -jnp.inf)

    def batch_shape(self):
        return jnp.shape(self.rate)


@_dist
class Geometric(Distribution):
    """Number of failures before first success, support 0,1,2,..."""
    p: Any

    def sample(self, key):
        p = _f(self.p)
        u = jr.uniform(key, jnp.shape(p), dtype=jnp.float32)
        return jnp.floor(jnp.log1p(-u) / jnp.log1p(-p)).astype(jnp.int32)

    def log_prob(self, value):
        p = jnp.clip(_f(self.p), 1e-37, 1.0)
        v = _f(value)
        # guard 0*(-inf) at (v=0, p=1): P(0)=1 there
        vterm = jnp.where(v > 0, v * jnp.log1p(-jnp.minimum(p, 1 - 1e-7)),
                          0.0)
        return jnp.where(v >= 0, vterm + jnp.log(p), -jnp.inf)

    def batch_shape(self):
        return jnp.shape(self.p)


@_dist
class LogNormal(Distribution):
    loc: Any
    scale: Any

    def sample(self, key):
        return jnp.exp(Normal(self.loc, self.scale).sample(key))

    def log_prob(self, value):
        v = _f(value)
        lv = jnp.log(jnp.maximum(v, 1e-37))
        lp = Normal(self.loc, self.scale).log_prob(lv) - lv
        return jnp.where(v > 0, lp, -jnp.inf)

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale))


@_dist
class Laplace(Distribution):
    loc: Any
    scale: Any

    def sample(self, key):
        loc, scale = _f(self.loc), _f(self.scale)
        shape = jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        return loc + scale * jr.laplace(key, shape, dtype=jnp.float32)

    def log_prob(self, value):
        loc, scale = _f(self.loc), _f(self.scale)
        return -jnp.abs(_f(value) - loc) / scale - jnp.log(2.0 * scale)

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale))


@_dist
class Cauchy(Distribution):
    loc: Any
    scale: Any

    def sample(self, key):
        loc, scale = _f(self.loc), _f(self.scale)
        shape = jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        return loc + scale * jr.cauchy(key, shape, dtype=jnp.float32)

    def log_prob(self, value):
        loc, scale = _f(self.loc), _f(self.scale)
        z = (_f(value) - loc) / scale
        return -jnp.log(jnp.pi * scale * (1.0 + z * z))

    def batch_shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale))


@_dist
class StudentT(Distribution):
    df: Any
    loc: Any
    scale: Any

    def sample(self, key):
        df, loc, scale = _f(self.df), _f(self.loc), _f(self.scale)
        shape = jnp.broadcast_shapes(
            jnp.shape(df), jnp.shape(loc), jnp.shape(scale))
        return loc + scale * jr.t(key, df, shape, dtype=jnp.float32)

    def log_prob(self, value):
        df, loc, scale = _f(self.df), _f(self.loc), _f(self.scale)
        z = (_f(value) - loc) / scale
        return (jsp_special.gammaln((df + 1.0) / 2.0)
                - jsp_special.gammaln(df / 2.0)
                - 0.5 * jnp.log(df * jnp.pi) - jnp.log(scale)
                - ((df + 1.0) / 2.0) * jnp.log1p(z * z / df))

    def batch_shape(self):
        return jnp.broadcast_shapes(
            jnp.shape(self.df), jnp.shape(self.loc), jnp.shape(self.scale))


@_dist
class MvNormalDiag(Distribution):
    """Multivariate normal with diagonal covariance; event = last axis."""
    loc: Any
    scale_diag: Any
    event_ndim = 1

    def sample(self, key):
        loc, sd = _f(self.loc), _f(self.scale_diag)
        shape = jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(sd))
        return loc + sd * jr.normal(key, shape, dtype=jnp.float32)

    def log_prob(self, value):
        return jnp.sum(Normal(self.loc, self.scale_diag).log_prob(value),
                       axis=-1)

    def batch_shape(self):
        return jnp.broadcast_shapes(
            jnp.shape(self.loc), jnp.shape(self.scale_diag))[:-1]


@_dist
class MvNormal(Distribution):
    """Multivariate normal with full covariance; event = last axis.

    The covariance Cholesky solve is a small matmul that batches across
    particles.
    """
    loc: Any
    cov: Any
    event_ndim = 1

    def _chol(self):
        return jnp.linalg.cholesky(_f(self.cov))

    def sample(self, key):
        loc = _f(self.loc)
        L = self._chol()
        eps = jr.normal(key, loc.shape, dtype=jnp.float32)
        return loc + jnp.einsum("...ij,...j->...i", L, eps)

    def log_prob(self, value):
        loc = _f(self.loc)
        L = self._chol()
        d = loc.shape[-1]
        diff = _f(value) - loc
        z = jax.scipy.linalg.solve_triangular(L, diff[..., None], lower=True)
        z = z[..., 0]
        logdet = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
        return (-0.5 * jnp.sum(z * z, axis=-1) - logdet
                - 0.5 * d * jnp.log(2.0 * jnp.pi))

    def batch_shape(self):
        return jnp.shape(self.loc)[:-1]


@_dist
class Factor(Distribution):
    """A soft factor: contributes ``logw`` to the score regardless of its
    (dummy, always-0) value. Unconstrained sites cancel out of ``generate``
    and fresh-``update`` weights, so a ``Factor(beta * loglik)`` site turns
    args-updates into tempered-SMC incremental weights
    (Δscore = Δbeta · loglik) — the TPU-native realization of annealing via
    trace translators (SURVEY.md C13)."""
    logw: Any

    def sample(self, key):
        return jnp.zeros(jnp.shape(self.logw), jnp.float32)

    def log_prob(self, value):
        return jnp.asarray(self.logw, jnp.float32)

    def batch_shape(self):
        return jnp.shape(self.logw)


@_dist
class Delta(Distribution):
    """Deterministic distribution (point mass) — useful for transformed sites."""
    value: Any

    def sample(self, key):
        return jnp.asarray(self.value)

    def log_prob(self, value):
        eq = jnp.asarray(value) == jnp.asarray(self.value)
        return jnp.where(eq, 0.0, -jnp.inf).astype(jnp.float32)

    def batch_shape(self):
        return jnp.shape(self.value)


# Lowercase constructors mirroring Gen's distribution names
normal = Normal
bernoulli = Bernoulli
uniform_discrete = UniformDiscrete
uniform = Uniform
categorical = Categorical
labeled_categorical = LabeledCategorical
poisson = Poisson
gamma = Gamma
beta = Beta
exponential = Exponential
geometric = Geometric
lognormal = LogNormal
laplace = Laplace
cauchy = Cauchy
student_t = StudentT
mvnormal_diag = MvNormalDiag
mvnormal = MvNormal
delta = Delta
factor = Factor
