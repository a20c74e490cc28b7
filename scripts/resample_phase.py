"""Resample-phase table on the GPU: where the resampling time goes in the
filters, against its byte floor, and the kernel candidates beside it.

Sections (each prints one JSON line and writes it to
``chiprun_out/resample_phase.jsonl``):

- ``phase``: for each gather path, device time inside the ``pf_resample`` scope of the
  object-motion filter (N=100K and N=1M, T=10) and the MOT K=4 filter
  (N=1M, T=10), read from a profiler trace of one warm run; the number of
  resample triggers; and the byte floor of one trigger: packed trace bytes
  read plus written over 3.35 TB/s (the H100 SXM data sheet).
- ``scan``: ``_cumsum1`` (blocked) against ``jnp.cumsum`` at N=1M.
- ``merge``: the roll-network ``_merge_count`` against
  ``jnp.searchsorted(u, c, side="right")`` at N=1M.
- ``gather``: parents-from-F plus the packed column gather, XLA against
  the Triton kernel (``ops/triton_gather.py``), at the N=1M object-motion
  pack; then the object-motion and MOT filters at N=1M with each path, in
  the order XLA, Triton, Triton, XLA.

Usage: ``python scripts/resample_phase.py [--small] [--sections
phase,scan,merge,gather]`` (``--small`` runs tiny shapes, with the Triton
kernel interpreted, for a CPU rehearsal). XLA wraps kernels in command
buffers (CUDA graphs); for a complete per-scope attribution run the
``phase`` section with ``XLA_FLAGS=--xla_gpu_enable_command_buffer=``.
"""

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import numpy as np  # noqa: E402

from genparticlefilters_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chiprun_out")


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "resample_phase.jsonl"), "a") as f:
        f.write(line + "\n")


def time_call(fn, *args, reps=20):
    """Median and min wall time (s) of ``fn(*args)`` ended by
    ``block_until_ready``, after one warm-up call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts)


# ---------------------------------------------------------------------------
# trace reduction: device time per named scope
# ---------------------------------------------------------------------------

def _op_names(hlo_text):
    """instruction name -> op_name metadata, from compiled HLO text."""
    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _norm(name):
    return re.sub(r"[.\-]", "_", name)


def _device_events(logdir):
    from jax.profiler import ProfileData
    paths = []
    for root, _, files in os.walk(logdir):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith(".xplane.pb")]
    assert paths, f"no trace under {logdir}"
    pd = ProfileData.from_file(sorted(paths)[-1])
    events, line_names = [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            line_names.append(f"{plane.name}|{line.name}")
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                events.append((ev.name, stats, ev.start_ns, ev.duration_ns))
    return events, line_names


def scope_times(compiled, run, scopes, logdir, top=0):
    """Trace one call of ``run()``; return per-scope device ns, kernel
    counts per HLO op, total busy ns, the traced window's wall ns and,
    with ``top``, the longest kernels with their op names.

    Only events of the module that holds most of the device time count.
    XLA wraps kernels in command buffers (CUDA graphs), whose events carry
    ``hlo_op=command_buffer``; those are attributed by kernel name, which
    is the fusion's instruction name with ``.`` and ``-`` made ``_``."""
    names = {_norm(k): v for k, v in _op_names(compiled.as_text()).items()}
    jax.block_until_ready(run())
    with jax.profiler.trace(logdir):
        t0 = time.perf_counter_ns()
        jax.block_until_ready(run())
        wall = time.perf_counter_ns() - t0
    events, line_names = _device_events(logdir)
    per_module = {}
    for _, stats, _, dur in events:
        m = str(stats.get("hlo_module", ""))
        per_module[m] = per_module.get(m, 0) + dur
    module = max(per_module, key=per_module.get) if per_module else ""
    per_scope = {s: 0 for s in scopes}
    counts = {s: {} for s in scopes}
    per_op = {}
    busy = unmatched = 0
    for name, stats, _, dur in events:
        if str(stats.get("hlo_module", "")) != module:
            continue
        busy += dur
        op = _norm(name)
        if op not in names:
            op = _norm(str(stats.get("hlo_op", name)))
        meta = names.get(op)
        if meta is None:
            unmatched += 1
            meta = ""
        per_op.setdefault(op, [0, 0, meta])
        per_op[op][0] += dur
        per_op[op][1] += 1
        for s in scopes:
            if f"/{s}/" in meta or meta.endswith(f"/{s}"):
                per_scope[s] += dur
                counts[s][op] = counts[s].get(op, 0) + 1
    longest = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(per_scope_ns=per_scope, busy_ns=busy, wall_ns=wall,
                module=module, n_events=sum(v[1] for v in per_op.values()),
                unmatched_events=unmatched,
                triggers={s: (min(c.values()) if c else 0)
                          for s, c in counts.items()},
                top_kernels=[dict(op=k, us=v[0] / 1e3, n=v[1],
                                  op_name=v[2][-120:]) for k, v in longest],
                lines=line_names[:12])


@contextlib.contextmanager
def gather_path(path, interpret=False):
    """Force the library's gather path (``xla`` or ``triton``) while the
    functions traced inside are built; ``interpret`` swaps in the
    interpreted kernel (CPU rehearsal)."""
    import functools
    from genparticlefilters_tpu.ops import triton_gather
    from genparticlefilters_tpu.smc import resample as rs
    saved = (rs._use_triton_gather, triton_gather.resample_gather)
    rs._use_triton_gather = lambda: path == "triton"
    if interpret:
        triton_gather.resample_gather = functools.partial(
            saved[1], interpret=True)
    try:
        yield
    finally:
        rs._use_triton_gather, triton_gather.resample_gather = saved


def packed_rows(traces):
    from genparticlefilters_tpu.smc.resample import (_flatten_with_axes,
                                                     _pack_rows)
    leaves, axes, _ = _flatten_with_axes(traces)
    rows, _ = _pack_rows(leaves, axes)
    return sum(r.shape[0] for r in rows if r is not None)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def phase_section(sizes, mot_n, T, logroot, interpret=False):
    import genparticlefilters_tpu as g
    from genparticlefilters_tpu.models.object_motion import (
        object_motion_filter_impl, synthesize_data)
    from genparticlefilters_tpu.models.multi_object import (
        MOTParams, mot_particle_filter, synthesize_mot_data)
    y_obs, _ = synthesize_data(jr.key(42), T, 5)
    cells = [(f"object_motion N={n} T={T} systematic",
              lambda k, n=n: object_motion_filter_impl(
                  k, y_obs, n, T, 0.5, "systematic"), n) for n in sizes]
    p = MOTParams()
    y_mot = synthesize_mot_data(jr.key(5), T, p)
    cells.append((f"mot K=4 N={mot_n} T={T} systematic",
                  lambda k: mot_particle_filter(k, y_mot, mot_n, T, p), mot_n))
    for (tag, fn, n), path in [(c, p) for c in cells
                               for p in ("xla", "triton")]:
        with gather_path(path, interpret=interpret):
            compiled = jax.jit(lambda k, fn=fn: fn(k)).lower(
                jr.key(1)).compile()
            alone_fn = jax.jit(lambda k, s: g.pf_resample(
                k, s, "systematic", check=False))
            st = compiled(jr.key(1))
            skewed = st.replace(log_weights=2.0 * jr.normal(jr.key(3), (n,)))
            alone = time_call(alone_fn, jr.key(4), skewed)[0]
        d = packed_rows(st.traces)
        k2 = jr.key(2)
        r = scope_times(compiled, lambda: compiled(k2), ["pf_resample"],
                        os.path.join(logroot, re.sub(r"\W+", "_",
                                                     f"{tag}_{path}")),
                        top=12)
        trig = r["triggers"]["pf_resample"]
        phase_ns = r["per_scope_ns"]["pf_resample"]
        floor_s = 2 * d * n * 4 / HBM_BYTES_PER_S
        emit(dict(section="phase", cell=tag, gather=path, packed_rows=d,
                  resample_device_ms=phase_ns / 1e6, triggers=trig,
                  resample_ms_per_trigger=(phase_ns / 1e6 / trig
                                           if trig else None),
                  byte_floor_ms_per_trigger=floor_s * 1e3,
                  isolated_resample_ms=alone * 1e3,
                  device_busy_ms=r["busy_ns"] / 1e6,
                  traced_wall_ms=r["wall_ns"] / 1e6,
                  n_device_events=r["n_events"],
                  unmatched_events=r["unmatched_events"],
                  lml=float(g.log_ml_estimate(st)),
                  top_kernels=r["top_kernels"]))


def _blocked_cumsum(x, L):
    k = x.shape[0] // L
    within = jnp.cumsum(x[:k * L].reshape(k, L), axis=1)
    offs = jnp.cumsum(within[:, -1])
    out = (within + jnp.concatenate([jnp.zeros((1,), x.dtype),
                                     offs[:-1]])[:, None]).reshape(k * L)
    return jnp.concatenate([out, jnp.cumsum(x[k * L:]) + out[-1]])


def scan_section(n):
    from genparticlefilters_tpu.smc.resample import _cumsum1
    for dtype in (jnp.float32, jnp.int32):
        x = (jr.uniform(jr.key(0), (n,)) if dtype == jnp.float32
             else jr.randint(jr.key(0), (n,), 0, 3, jnp.int32))
        variants = {"blocked_512": jax.jit(_cumsum1),
                    "cumsum": jax.jit(jnp.cumsum),
                    "associative_scan": jax.jit(
                        lambda v: jax.lax.associative_scan(jnp.add, v))}
        for L in [L for L in (128, 1024, 4096) if 8 * L <= n]:
            variants[f"blocked_{L}"] = jax.jit(
                lambda v, L=L: _blocked_cumsum(v, L))
        ms = {k: [] for k in variants}
        for _ in range(2):
            for k, f in variants.items():
                ms[k].append(time_call(f, x)[0] * 1e3)
        ref = np.cumsum(np.asarray(x, np.float64))
        err = {k: float(np.max(np.abs(np.asarray(f(x), np.float64) - ref)))
               for k, f in variants.items()}
        emit(dict(section="scan", n=n, dtype=jnp.dtype(dtype).name, ms=ms,
                  max_abs_err_vs_float64=err))


def merge_section(n):
    from genparticlefilters_tpu.smc.resample import (_merge_count,
                                                     _sorted_uniforms_cum,
                                                     _cumsum1, _cummax1)
    w = jax.nn.softmax(jr.normal(jr.key(3), (n,)) * 3.0)
    c_raw = _cumsum1(w)
    c = _cummax1(c_raw)
    c = c / c[-1]
    ce = _sorted_uniforms_cum(jr.key(4), n)
    u = ce[:-1] / ce[-1]
    roll = jax.jit(_merge_count)
    ss = jax.jit(lambda c, u: jnp.searchsorted(u, c, side="right")
                 .astype(jnp.int32))
    ss_sort = jax.jit(lambda c, u: jnp.searchsorted(
        u, c, side="right", method="sort").astype(jnp.int32))
    ref = np.searchsorted(np.asarray(u), np.asarray(c), side="right")
    equal = {k: bool(np.array_equal(np.asarray(f(c, u)), ref))
             for k, f in (("roll", roll), ("scan", ss), ("sort", ss_sort))}
    ms = {"roll_network": [], "searchsorted_scan": [], "searchsorted_sort": []}
    for _ in range(2):
        for k, f in zip(ms, (roll, ss, ss_sort)):
            ms[k].append(time_call(f, c, u)[0] * 1e3)
    emit(dict(section="merge", n=n, equal_to_numpy=equal, ms=ms,
              cumsum_decreases=int(jnp.sum(jnp.diff(c_raw) < 0))))


def gather_section(n, T, interpret):
    from genparticlefilters_tpu.ops.triton_gather import resample_gather
    from genparticlefilters_tpu.smc import resample as rs
    from genparticlefilters_tpu.models.object_motion import (
        object_motion_filter_impl, synthesize_data)
    from genparticlefilters_tpu.models.multi_object import (
        MOTParams, mot_particle_filter, synthesize_mot_data)
    reps = 3 if interpret else 20
    y_obs, _ = synthesize_data(jr.key(42), T, 5)
    with gather_path("xla"):
        st = jax.jit(lambda k: object_motion_filter_impl(
            k, y_obs, n, T, 0.5, "systematic"))(jr.key(1))
    big, _, _, _ = rs._pack(st.traces)
    w = jax.nn.softmax(jr.normal(jr.key(9), (n,)) * 3.0)
    F = rs.systematic_F(jr.key(10), w, n)
    xla = jax.jit(lambda big, F: (
        jnp.take(big, rs._F_to_parents(F, n), axis=1),
        rs._F_to_parents(F, n)))
    ox, px = xla(big, F)
    tri = jax.jit(lambda big, F: resample_gather(big, F, n,
                                                 interpret=interpret))
    ot, pt = tri(big, F)
    assert bool(jnp.array_equal(ox, ot)) and bool(
        jnp.array_equal(px, pt)), "Triton gather disagrees with XLA"
    ms = {"xla": [], "triton": []}
    for _ in range(2):
        ms["xla"].append(time_call(xla, big, F, reps=reps)[0] * 1e3)
        ms["triton"].append(time_call(tri, big, F, reps=reps)[0] * 1e3)
    emit(dict(section="gather", n=n, packed_rows=int(big.shape[0]),
              equal=True, ms=ms,
              byte_floor_ms=2 * big.size * 4 / HBM_BYTES_PER_S * 1e3))

    # end to end, in turns: the XLA path and the Triton kernel
    p = MOTParams()
    y_mot = synthesize_mot_data(jr.key(5), T, p)
    cells = {
        f"object_motion N={n} T={T} systematic":
            lambda k: object_motion_filter_impl(
                k, y_obs, n, T, 0.5, "systematic").log_ml_est,
        f"mot K=4 N={n} T={T} systematic":
            lambda k: mot_particle_filter(k, y_mot, n, T, p).log_ml_est}
    for cell, fn in cells.items():
        built = {}
        for name in ("xla", "triton"):
            with gather_path(name, interpret=interpret):
                # a fresh wrapper per variant: jit caches traces by function
                built[name] = jax.jit(lambda k, fn=fn: fn(k)).lower(
                    jr.key(0)).compile()
        lml = {k: float(f(jr.key(3))) for k, f in built.items()}
        order = list(built) + list(built)[::-1]
        res = {k: [] for k in built}
        k4 = jr.key(4)
        for name in order:
            res[name].append(time_call(built[name], k4, reps=reps)[0] * 1e3)
        emit(dict(section="gather_end_to_end", cell=cell, lml=lml,
                  filter_ms=res, order=order))
        for name, f in built.items():
            r = scope_times(f, lambda f=f: f(k4), ["pf_resample"],
                            os.path.join(OUT_DIR, "traces", re.sub(
                                r"\W+", "_", f"filter_{cell}_{name}")),
                            top=15)
            emit(dict(section="filter_trace", cell=cell, variant=name,
                      resample_device_ms=r["per_scope_ns"]["pf_resample"]
                      / 1e6,
                      triggers=r["triggers"]["pf_resample"],
                      device_busy_ms=r["busy_ns"] / 1e6,
                      traced_wall_ms=r["wall_ns"] / 1e6,
                      unmatched_events=r["unmatched_events"],
                      top_kernels=r["top_kernels"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--sections", default="phase,scan,merge,gather")
    args = ap.parse_args()
    sections = args.sections.split(",")
    use_compile_cache()
    dev = jax.devices()[0]
    if not args.small:
        assert dev.platform == "gpu", f"needs a GPU, found {dev.platform}"
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    else:
        smi = "not measured (CPU rehearsal)"
    emit(dict(section="device", platform=dev.platform,
              kind=dev.device_kind, count=len(jax.devices()),
              nvidia_smi=smi, xla_flags=os.environ.get("XLA_FLAGS", "")))
    T = 10
    big_n = 2048 if args.small else 1_000_000
    sizes = [1000, 2048] if args.small else [100_000, 1_000_000]
    logroot = os.path.join(OUT_DIR, "traces")
    if "phase" in sections:
        phase_section(sizes, big_n, T, logroot, interpret=args.small)
    if "scan" in sections:
        scan_section(big_n)
    if "merge" in sections:
        merge_section(big_n)
    if "gather" in sections:
        gather_section(big_n, T, interpret=args.small)


if __name__ == "__main__":
    main()
