"""genparticlefilters_tpu: a TPU-native sequential Monte Carlo framework.

A from-scratch reimplementation of the capabilities of
probcomp/GenParticleFilters.jl (reference at /root/reference) designed
TPU-first: traces are fixed-shape pytrees, per-particle loops are ``jax.vmap``
over a particle axis, resampling/diagnostics are static-shape XLA
computations, and multi-device scaling uses ``jax.sharding`` meshes with
shard-local resampling plus explicit collectives.
"""

from . import core as _core
from . import smc as _smc

from .core import *  # noqa: F401,F403
from .smc import *  # noqa: F401,F403

__all__ = _core.__all__ + _smc.__all__

__version__ = "0.1.0"
