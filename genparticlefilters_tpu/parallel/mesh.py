"""Device mesh + sharded particle states.

The reference has no distributed backend (SURVEY.md §2: its parallelism-
shaped features are particle views, stratification, and replication). The
TPU-native realization: the particle axis of every state leaf is sharded
over a 1-D ``jax.sharding.Mesh`` axis (named ``"p"``); a shard is exactly a
:class:`~..smc.state.ParticleFilterSubState` block, so the reference's
sub-state weight semantics (/root/reference/src/resample.jl:205-218) are the
correctness spec for shard-local operations. Global reductions (ESS, LML,
normalization) lower to ``psum``-style collectives XLA inserts automatically
for sharded inputs; cross-shard ancestry uses all-to-all gathers only in the
exact/global resampling path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..smc.state import ParticleFilterState

__all__ = ["particle_mesh", "shard_state", "state_sharding",
           "state_pspecs", "replicated_sharding"]

PARTICLE_AXIS = "p"


def particle_mesh(devices=None, axis_name: str = PARTICLE_AXIS) -> Mesh:
    """1-D mesh over all (or given) devices with the particle axis."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(devices, (axis_name,))


def state_pspecs(state, axis_name: str = PARTICLE_AXIS, n: int | None = None):
    """``PartitionSpec`` pytree for any state-like pytree (a full state, a
    bare trace, or arbitrary containers of them): every leaf that carries
    the particle axis (per-leaf position from the trace layout spec —
    time-major stacked leaves shard axis 1) gets ``axis_name`` at that
    position; particle-shared leaves and scalars get ``P()`` (replicated).
    These specs drive both GSPMD placement (:func:`state_sharding`) and the
    explicit ``jax.shard_map`` collective paths in
    :mod:`~genparticlefilters_tpu.parallel.distributed`."""
    from ..core.batching import axes_spec, spec_map
    if n is None:
        n = state.n_particles
    spec = axes_spec(state)

    def leaf_pspec(leaf, ax):
        shape = jnp.shape(leaf) if hasattr(leaf, "shape") else ()
        if (ax is not None and len(shape) > ax and shape[ax] == n):
            parts = [None] * (ax + 1)
            parts[ax] = axis_name
            return P(*parts)
        return P()

    return spec_map(leaf_pspec, state, spec)


def state_sharding(mesh: Mesh, state: ParticleFilterState,
                   axis_name: str = PARTICLE_AXIS):
    """Sharding pytree: every leaf is sharded along its particle axis (the
    per-leaf position comes from the trace layout spec — time-major stacked
    leaves shard axis 1); particle-shared leaves and scalars are
    replicated."""
    return jax.tree_util.tree_map(
        lambda ps: NamedSharding(mesh, ps),
        state_pspecs(state, axis_name),
        is_leaf=lambda x: isinstance(x, P))


def replicated_sharding(mesh: Mesh):
    return NamedSharding(mesh, P())


def shard_state(state: ParticleFilterState, mesh: Mesh,
                axis_name: str = PARTICLE_AXIS) -> ParticleFilterState:
    """Place a state on the mesh with the particle axis sharded."""
    sh = state_sharding(mesh, state, axis_name)
    return jax.tree_util.tree_map(
        lambda leaf, s: jax.device_put(leaf, s), state, sh)
