"""Hand-written GPU kernels that beat plain XLA end to end on the H100
(each names its route; timings in ``PERF.md``)."""
