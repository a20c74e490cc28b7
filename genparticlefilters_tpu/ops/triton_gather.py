"""Resampling gather as one Pallas kernel, compiled through Triton.

``resample_gather(big, F, n_out)`` returns ``(big[:, parents], parents)``
where output column ``j``'s parent is ``#{i : F_i <= j}`` for the
non-decreasing cumulative offspring counts ``F`` (``F[-1] == n_out``).
XLA builds the same result from a scatter, a cummax and a column gather
(``smc.resample._F_to_parents`` then ``jnp.take``); here each block owns
``block`` output columns, finds their parents by a binary search over
``F`` and copies the ``D`` packed rows. The kernel's row-major operands
also keep XLA from giving the gathered trace storage a transposed layout,
which made every later per-step update of that storage a strided write
(see ``PERF.md``).

``smc.resample._use_triton_gather`` decides where it runs; the plain
reference is ``_F_to_parents`` plus ``jnp.take``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["resample_gather"]

# output columns per program and warps per program: 1024 x 4 was the best
# of five settings on an H100 at N=1M, D=43 (PERF.md)
_BLOCK = 1024
_NUM_WARPS = 4


def _kernel(f_ref, big_ref, out_ref, par_ref, *, n_src, n_out, d, block):
    start = pl.program_id(0) * block
    cols = start + jnp.arange(block, dtype=jnp.int32)
    mask = cols < n_out

    def search(_, lohi):
        # invariant: F[lo-1] <= col < F[hi] (F[-1] = -inf, F[n_src] = +inf)
        lo, hi = lohi
        mid = (lo + hi) // 2
        f_mid = plt.load(f_ref.at[jnp.minimum(mid, n_src - 1)])
        right = (f_mid <= cols) & (lo < hi)
        return (jnp.where(right, mid + 1, lo),
                jnp.where(right | (lo >= hi), hi, mid))

    lo0 = jnp.zeros((block,), jnp.int32)
    hi0 = jnp.full((block,), n_src, jnp.int32)
    lo, _ = lax.fori_loop(0, max(1, n_src.bit_length()), search, (lo0, hi0))
    parents = jnp.minimum(lo, n_src - 1)
    plt.store(par_ref.at[pl.ds(start, block)], parents, mask=mask)

    def copy_row(r, carry):
        row = plt.load(big_ref.at[r, parents])
        plt.store(out_ref.at[r, pl.ds(start, block)], row, mask=mask)
        return carry

    lax.fori_loop(0, d, copy_row, 0)


@functools.partial(jax.jit, static_argnames=("n_out", "interpret"))
def resample_gather(big, F, n_out: int, interpret: bool = False):
    """``(big[:, parents], parents)`` with ``parents_j = #{i : F_i <= j}``.

    ``big``: [D, n_src] int32 packed trace rows (D >= 1); ``F``: [n_src]
    non-decreasing int32 cumulative offspring counts ending at ``n_out``.
    ``interpret=True`` runs the kernel on the CPU through the Pallas
    interpreter."""
    d, n_src = big.shape
    kernel = functools.partial(_kernel, n_src=n_src, n_out=n_out, d=d,
                               block=_BLOCK)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n_out, _BLOCK),),
        out_shape=(jax.ShapeDtypeStruct((d, n_out), big.dtype),
                   jax.ShapeDtypeStruct((n_out,), jnp.int32)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="resample_gather",
    )(F.astype(jnp.int32), big)
