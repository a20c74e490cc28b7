"""Log-weight math: lognorm / softmax / safe_softmax and ESS.

Semantics mirror the reference's weight utilities
(/root/reference/src/utils.jl:100-140): ``safe_softmax`` returns
``(weights, invalid)`` where invalid outputs arise from NaN inputs or an
all ``-inf`` weight vector (renormalized to uniform). All functions are
jittable; the ``invalid`` flag is a traced bool so callers can plumb the
reference's ``check ∈ {True, :warn, False}`` policy through jit (eager
callers get a Python raise; jitted callers get a debug-callback warning).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

__all__ = ["lognorm", "softmax", "safe_softmax", "ess_from_log_weights",
           "apply_check", "logsumexp"]


def lognorm(vs):
    """Log-normalize a vector of log weights (ref: src/utils.jl:100)."""
    return vs - logsumexp(vs)


def softmax(vs):
    """Softmax of (unnormalized) log probabilities (ref: src/utils.jl:103-107)."""
    m = jnp.max(vs)
    ws = jnp.exp(vs - m)
    return ws / jnp.sum(ws)


def safe_softmax(vs):
    """Returns ``(weights, invalid)`` (ref: src/utils.jl:117-140).

    - any NaN input          -> NaN weights, invalid
    - all inputs are -inf    -> uniform weights, invalid
    - otherwise              -> normalized weights, valid
    """
    n = vs.shape[-1]
    any_nan = jnp.any(jnp.isnan(vs))
    m = jnp.max(vs)
    all_neginf = m == -jnp.inf
    safe_vs = jnp.where(all_neginf | any_nan, 0.0, vs - m)
    ws = jnp.exp(safe_vs)
    total = jnp.sum(ws)
    norm = ws / total
    uniform = jnp.full((n,), 1.0 / n, dtype=vs.dtype)
    out = jnp.where(all_neginf, uniform, norm)
    out = jnp.where(any_nan, jnp.nan, out)
    invalid = any_nan | all_neginf
    return out, invalid


def ess_from_log_weights(log_weights):
    """Effective sample size 1/Σ ŵ² (ref: src/utils.jl:159-164)."""
    lw = lognorm(log_weights)
    return jnp.exp(-logsumexp(2.0 * lw))


def _warn_invalid(invalid):
    import numpy as np
    if np.any(invalid):
        print("[genparticlefilters_tpu] warning: invalid normalized weights "
              "(NaN or all -inf); renormalized per safe_softmax policy.")


def _raise_invalid(invalid):
    import numpy as np
    if np.any(invalid):
        raise FloatingPointError("Invalid weights (NaN or all -inf).")


def apply_check(invalid, check):
    """Implement the reference's ``check`` policy (src/resample.jl:53-55;
    hard-stop semantics: src/utils.jl:117-140).

    - ``check=True``: raise if invalid. Eagerly this is a Python
      ``FloatingPointError``; under jit the flag is a tracer, so a raising
      ``jax.debug.callback`` is staged instead — the exception surfaces as a
      ``jax.errors.JaxRuntimeError`` when the computation executes (i.e. at
      dispatch/fetch time), restoring the reference's hard-stop contract
      inside jitted filters.

      .. note:: the jitted raise is **best-effort**: exceptions from debug
         callbacks are not a guaranteed error channel — delivery is
         asynchronous and backend-dependent, the error surfaces at the next
         host synchronization point (which may be far from the offending
         op). It is a fail-loud diagnostic, not a
         recoverable control-flow signal: never ``except`` it to continue
         the same computation. For a value-level error channel that is
         guaranteed under jit, run the filter under
         ``jax.experimental.checkify`` or branch on the ``invalid`` flag
         returned by :func:`safe_softmax` yourself.
    - ``check="warn"``: report via debug callback when invalid.
    - ``check=False``: silent.
    """
    if check is False:
        return
    if not isinstance(invalid, jax.core.Tracer):
        if bool(invalid):
            if check is True:
                raise FloatingPointError(
                    "Invalid weights (NaN or all -inf).")
            _warn_invalid(True)
        return
    if check is True:
        jax.debug.callback(_raise_invalid, invalid)
    else:
        jax.debug.callback(_warn_invalid, invalid)
