"""Global library settings."""

from __future__ import annotations

import contextlib

#: Trace-time guard against the batched-interpretation shape ambiguity: a
#: genuinely unbatched array whose leading dim equals the particle count N
#: is indistinguishable from a per-particle value inside a batched
#: interpretation (core/gfi.py batchedness convention). When enabled, the
#: batched pf_initialize/pf_update paths compare the batched trace layout
#: against an abstract (eval_shape) per-particle interpretation and raise
#: if any leaf's shape is inconsistent — turning silent misinterpretation
#: into an immediate error. Costs one extra abstract trace per
#: compilation; disable only if model tracing is prohibitively slow.
check_batched_layout: bool = True


@contextlib.contextmanager
def use_check_batched_layout(enabled: bool = True):
    global check_batched_layout
    prev = check_batched_layout
    check_batched_layout = enabled
    try:
        yield
    finally:
        check_batched_layout = prev

