"""Smoke run of the SMC main path on one GPU, checked against references.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --devices 4  # four cards: the sharded step only

Phases (one card):

0. kernel — the Triton resampling gather (``ops/triton_gather.py``),
   compiled for the card, against its plain XLA reference at the packed
   widths of the states below;
1. headline filter — ``object_motion_filter`` at N=100K, T=10, 8 replicate
   keys in one jit, once with systematic resampling and once with residual
   resampling (MH rejuvenation in both), against the exact 2^10-path
   enumeration posterior; then once at N=1M;
2. resampling layer — every ``pf_resample`` method and
   ``pf_multinomial_resize`` / ``pf_residual_resize`` (1M -> 500K -> 1M) on
   a real N=1M object-motion state with skewed weights;
3. config 5 — the multi-object tracking filter (K=4, N=1M, T=10) with a
   mid-stream resize 1M -> 500K -> 1M, against the exact Kalman LML;
4. config 2 — the linear-Gaussian SSM at N=10K against the exact Kalman
   filter.

``--devices 4`` shards object-motion at N=4M over a 1-D mesh of four cards
and compares one SMC step with the same step on one card.

Each phase prints its checks with their tolerances, its wall time and the
compiled step's memory analysis; the run stops at the first failed check.
The last line is ``{"ok": true, "device": {...}}``. The script refuses to
run without a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as g  # noqa: E402
from genparticlefilters_tpu.core.batching import tree_take  # noqa: E402
from genparticlefilters_tpu.models.object_motion import (  # noqa: E402
    object_motion_filter_impl, synthesize_data)
from genparticlefilters_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


class PhaseFailed(Exception):
    pass


def check(phase, name, value, tol, ok):
    """Print one check line; raise :class:`PhaseFailed` when it fails."""
    print(f"  [{phase}] {name}: {value} (tolerance: {tol}) -> "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailed(f"{phase}: {name} = {value}, tolerance {tol}")


def memory_line(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{k.replace('_size_in_bytes', '')}={getattr(m, k, 0) / 2**20:.1f}MiB"
        for k in keys)


def compile_fn(fn, *args):
    return jax.jit(fn).lower(*args).compile()


def _logsumexp64(x):
    x = np.asarray(x, np.float64)
    m = x.max()
    return m + math.log(np.exp(x - m).sum())


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def exact_object_motion(yo):
    """Exact P(moving@t) and LML of the object-motion model by enumerating
    all 2^T moving paths (per path, a scalar Kalman filter over y)."""
    T = len(yo)
    paths = np.array(list(itertools.product([False, True], repeat=T)))
    lj = np.zeros(len(paths))
    for i, m in enumerate(paths):
        mu = var = ll = 0.0
        prev = False
        for t in range(T):
            p = 0.75 if prev else 0.25
            ll += math.log(p) if m[t] else math.log(1 - p)
            prev = m[t]
            mu, var = mu + (math.sin(t + 1) if m[t] else 0.0), var + 1e-4
            s = var + 0.0625
            ll += -0.5 * (yo[t] - mu) ** 2 / s - 0.5 * math.log(
                2 * math.pi * s)
            k = var / s
            mu, var = mu + k * (yo[t] - mu), var * (1 - k)
        lj[i] = ll
    w = np.exp(lj - lj.max())
    lml = math.log(w.sum()) + lj.max()
    w /= w.sum()
    return w @ paths, lml


def kalman_lml_1d(y, q, r, s0):
    """Exact LML of x_0 ~ N(0, s0^2), x_t ~ N(x_{t-1}, q^2), y_t ~ N(x_t,
    r^2) in float64."""
    mu, var, ll = 0.0, s0 ** 2, 0.0
    for t, yt in enumerate(y):
        if t > 0:
            var = var + q ** 2
        s = var + r ** 2
        ll += -0.5 * (yt - mu) ** 2 / s - 0.5 * math.log(2 * math.pi * s)
        k = var / s
        mu, var = mu + k * (yt - mu), (1 - k) * var
    return ll


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def headline_phase(n=100_000, T=10, reps=8, big_n=1_000_000):
    """Object-motion filter against exact enumeration, both resampling
    settings; then one run at ``big_n``."""
    y_obs, _ = synthesize_data(jr.key(42), T, 5)
    post, lml_exact = exact_object_motion(np.asarray(y_obs, np.float64))
    for method in ("systematic", "residual"):
        def run(keys, method=method):
            def one(k):
                st = object_motion_filter_impl(k, y_obs, n, T, 0.5, method)
                pm = jnp.stack([g.mean(st, (t, "moving")) for t in range(T)])
                return pm, g.log_ml_estimate(st)
            return jax.vmap(one)(keys)

        keys = jr.split(jr.key(7), reps)
        t0 = time.perf_counter()
        compiled = compile_fn(run, keys)
        pm, lml = jax.block_until_ready(compiled(keys))
        wall = time.perf_counter() - t0
        pm, lml = np.asarray(pm, np.float64), np.asarray(lml, np.float64)
        tag = f"headline {method} N={n} T={T} x{reps}"
        print(f"[{tag}] wall {wall:.2f}s (compile + run); "
              + memory_line(compiled), flush=True)
        se = pm.std(0, ddof=1) / math.sqrt(reps)
        dev = np.abs(pm.mean(0) - post)
        check(tag, "max_t |P(moving@t) - exact| - 5*SE_t",
              float(np.max(dev - 5 * se)), "<= 0.005",
              bool(np.all(dev <= 5 * se + 0.005)))
        check(tag, "|mean LML - exact LML|",
              abs(float(lml.mean()) - lml_exact), "<= 0.05",
              abs(float(lml.mean()) - lml_exact) <= 0.05)
    f = lambda k: g.log_ml_estimate(object_motion_filter_impl(
        k, y_obs, big_n, T, 0.5, "systematic"))
    t0 = time.perf_counter()
    compiled = compile_fn(f, jr.key(3))
    v = float(compiled(jr.key(3)))
    tag = f"headline systematic N={big_n} T={T}"
    print(f"[{tag}] wall {time.perf_counter() - t0:.2f}s (compile + run); "
          + memory_line(compiled), flush=True)
    check(tag, "|LML - exact LML|", abs(v - lml_exact), "<= 0.05",
          abs(v - lml_exact) <= 0.05)


def kernel_phase(n=1_000_000, cases=((43, 1_000_000), (161, 1_000_000),
                                     (43, 500_000)), interpret=False):
    """The Triton resampling gather, compiled for the card, against its
    plain reference (``_F_to_parents`` + ``jnp.take``) at the packed widths
    of the object-motion (43 rows) and MOT K=4 (161 rows) states, and for a
    resize to half the particles."""
    from genparticlefilters_tpu.ops.triton_gather import resample_gather
    from genparticlefilters_tpu.smc import resample as rs
    tag0 = "kernel triton resample_gather"
    print(f"[{tag0}] gather path chosen by the library: "
          f"{'triton' if rs._use_triton_gather() else 'xla'}", flush=True)
    for d, n_out in cases:
        big = jr.randint(jr.key(d), (d, n), -2**31, 2**31 - 1, jnp.int32)
        w = jax.nn.softmax(2.0 * jr.normal(jr.key(1), (n,)))
        F = rs.multinomial_F(jr.key(2), w, n_out)
        tag = f"{tag0} D={d} N={n}->{n_out}"
        t0 = time.perf_counter()
        compiled = compile_fn(lambda b, f: resample_gather(
            b, f, n_out, interpret=interpret), big, F)
        out, parents = jax.block_until_ready(compiled(big, F))
        print(f"[{tag}] wall {time.perf_counter() - t0:.2f}s (compile + run); "
              + memory_line(compiled), flush=True)
        ref_parents = rs._F_to_parents(F, n_out)
        same_p = bool(jnp.array_equal(parents, ref_parents))
        same = bool(jnp.array_equal(out, jnp.take(big, ref_parents, axis=1)))
        check(tag, "parents == _F_to_parents(F)", same_p, "exact", same_p)
        check(tag, "rows == take(big, parents, axis=1)", same, "exact", same)


def _skewed_state(n, T, key, sigma=2.0):
    """A real object-motion filter state at ``n`` particles whose log
    weights are replaced by N(0, sigma^2) draws."""
    y_obs, _ = synthesize_data(jr.key(42), T, 5)
    st = jax.jit(lambda k: object_motion_filter_impl(
        k, y_obs, n, T, 0.5, "systematic"))(key)
    return st.replace(log_weights=sigma * jr.normal(jr.fold_in(key, 1), (n,)))


def _leaves_equal(old_traces, new_traces, parents):
    want = tree_take(old_traces, parents)
    return all(bool(jnp.array_equal(a, b)) for a, b in zip(
        jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(new_traces)))


def _check_resampled(tag, old, new, n_out, law=None):
    parents = np.asarray(new.parents)
    same = _leaves_equal(old.traces, new.traces, new.parents)
    check(tag, "output leaves == old_leaf[parents] (bitwise)", same, "exact",
          same)
    lo, hi = int(parents.min()), int(parents.max())
    check(tag, "parents range", f"[{lo}, {hi}]", f"[0, {old.n_particles})",
          lo >= 0 and hi < old.n_particles)
    lw64 = np.asarray(old.log_weights, np.float64)
    ref = (float(old.log_ml_est) + _logsumexp64(lw64)
           - math.log(old.n_particles))
    got = float(new.log_ml_est)
    rel = abs(got - ref) / max(abs(ref), 1e-30)
    check(tag, "folded LML rel. error vs float64 logsumexp - log N", rel,
          "<= 1e-5", rel <= 1e-5)
    if law is None:
        return
    w = np.exp(lw64 - lw64.max())
    nw = n_out * w / w.sum()
    counts = np.bincount(parents, minlength=old.n_particles)
    # f32 cumulative weights carry ~1 ulp of n_out per step
    eps = 4 * float(np.spacing(np.float32(n_out)))
    if law == "systematic":
        bad = int(np.sum((counts < np.floor(nw - eps))
                         | (counts > np.ceil(nw + eps))))
        check(tag, "offspring counts outside {floor(Nw), ceil(Nw)}", bad,
              f"0 (eps={eps:g})", bad == 0)
    else:
        bad = int(np.sum(counts < np.floor(nw - eps)))
        check(tag, "offspring counts below floor(Nw)", bad,
              f"0 (eps={eps:g})", bad == 0)


def resampling_phase(n=1_000_000, T=10):
    """Every resampling method and both resizes on a skewed real state."""
    old = _skewed_state(n, T, jr.key(11))
    cases = [("multinomial", {}, None), ("residual", {}, "residual"),
             ("stratified", {"sort_particles": True}, None),
             ("stratified", {"sort_particles": False}, None),
             ("systematic", {}, "systematic")]
    for method, kw, law in cases:
        tag = f"resample {method}{' ' + str(kw) if kw else ''} N={n}"
        t0 = time.perf_counter()
        compiled = compile_fn(lambda k, s, method=method, kw=kw: g.pf_resample(
            k, s, method, check=False, **kw), jr.key(5), old)
        new = jax.block_until_ready(compiled(jr.key(5), old))
        print(f"[{tag}] wall {time.perf_counter() - t0:.2f}s "
              f"(compile + run); " + memory_line(compiled), flush=True)
        _check_resampled(tag, old, new, n, law)
    half = n // 2
    for name, fn, law in (("multinomial", g.pf_multinomial_resize, None),
                          ("residual", g.pf_residual_resize, "residual")):
        state = old
        for n_out in (half, n):
            tag = f"resize {name} {state.n_particles}->{n_out}"
            t0 = time.perf_counter()
            compiled = compile_fn(lambda k, s, fn=fn, n_out=n_out: fn(
                k, s, n_out, check=False), jr.key(6), state)
            new = jax.block_until_ready(compiled(jr.key(6), state))
            print(f"[{tag}] wall {time.perf_counter() - t0:.2f}s "
                  f"(compile + run); " + memory_line(compiled), flush=True)
            _check_resampled(tag, state, new, n_out, law)
            # re-skew the resized state so the way back resamples too
            state = new.replace(log_weights=2.0 * jr.normal(
                jr.key(n_out), (n_out,)))


def mot_lml(key, y, n, T, p):
    """MOT filter with a mid-stream resize n -> n/2 -> n (config 5)."""
    from genparticlefilters_tpu.core import Extend, NoChange
    from genparticlefilters_tpu.models.multi_object import (make_mot_model,
                                                            mot_obs_dense)
    model = make_mot_model(T, p)
    x0 = jnp.zeros((p.n_objects, 2), jnp.float32)
    obs = mot_obs_dense(y)
    k0, kloop = jr.split(key)
    st = g.pf_initialize(k0, model, (1, x0), obs, n)

    def make_step(n_now):
        def step(st, t):
            kr, ku = jr.split(jr.fold_in(kloop, t))
            ess = g.effective_sample_size(st)
            st = jax.lax.cond(
                ess < 0.5 * n_now,
                lambda s: g.pf_resample(kr, s, "systematic", check=False),
                lambda s: s, st)
            st = g.pf_update(ku, st, (t + 1, x0), (Extend(1), NoChange()),
                             obs, check=False)
            return st, None
        return step

    t1, t2 = T // 3, 2 * T // 3
    st, _ = jax.lax.scan(make_step(n), st, jnp.arange(1, t1, dtype=jnp.int32))
    st = g.pf_resize(jr.fold_in(kloop, 1001), st, n // 2, "residual",
                     check=False)
    st, _ = jax.lax.scan(make_step(n // 2), st,
                         jnp.arange(t1, t2, dtype=jnp.int32))
    st = g.pf_resize(jr.fold_in(kloop, 1002), st, n, "multinomial",
                     check=False)
    st, _ = jax.lax.scan(make_step(n), st, jnp.arange(t2, T, dtype=jnp.int32))
    return g.log_ml_estimate(st)


#: |LML - exact| bound for config 5 at N=1M, in nats: 5x the 1.9-nat
#: standard deviation of 15 CPU rehearsal runs (mean error -2.4). The
#: bootstrap proposal collapses at t=0 (prior sd 2 against observation sd
#: 0.5 in 8 coordinates), so the estimate is wide even at N=1M.
MOT_LML_TOL = 10.0


def config5_phase(n=1_000_000, T=10, tol=MOT_LML_TOL):
    from genparticlefilters_tpu.models.multi_object import (
        MOTParams, synthesize_mot_data)
    p = MOTParams()
    y = synthesize_mot_data(jr.key(5), T, p)
    y64 = np.asarray(y, np.float64)
    exact = sum(kalman_lml_1d(y64[:, k, d], p.q, p.r, p.s0)
                for k in range(p.n_objects) for d in range(2))
    tag = f"config5 MOT K={p.n_objects} N={n} T={T} resize {n}->{n // 2}->{n}"
    t0 = time.perf_counter()
    compiled = compile_fn(lambda k: mot_lml(k, y, n, T, p), jr.key(8))
    v = float(compiled(jr.key(8)))
    print(f"[{tag}] wall {time.perf_counter() - t0:.2f}s (compile + run); "
          + memory_line(compiled), flush=True)
    check(tag, "|LML - exact Kalman LML|", abs(v - exact), f"<= {tol}",
          abs(v - exact) <= tol)


def config2_phase(n=10_000, T=50, reps=8):
    from genparticlefilters_tpu.models.linear_gaussian import (
        LGParams, kalman_filter, lgssm_particle_filter, synthesize_lg_data)
    p = LGParams()
    y = synthesize_lg_data(jr.key(0), T, p)
    mus, _, lml_exact = kalman_filter(y, p)

    def run(keys):
        def one(k):
            st = lgssm_particle_filter(k, y, n, T, p)
            return g.mean(st, (T - 1, "x")), g.log_ml_estimate(st)
        return jax.vmap(one)(keys)

    keys = jr.split(jr.key(9), reps)
    tag = f"config2 linear-Gaussian N={n} T={T} x{reps}"
    t0 = time.perf_counter()
    compiled = compile_fn(run, keys)
    m, lml = (np.asarray(a, np.float64) for a in compiled(keys))
    n_dot = compiled.as_text().count(" dot(")
    print(f"[{tag}] wall {time.perf_counter() - t0:.2f}s (compile + run); "
          f"matmul precision {jax.config.jax_default_matmul_precision}, "
          f"{n_dot} dot ops in the compiled filter; " + memory_line(compiled),
          flush=True)
    se_m = m.std(ddof=1) / math.sqrt(reps)
    check(tag, "|E[x_T] - Kalman mean| - 5*SE", abs(m.mean() - float(mus[-1]))
          - 5 * se_m, "<= 0.01",
          abs(m.mean() - float(mus[-1])) <= 5 * se_m + 0.01)
    se_l = lml.std(ddof=1) / math.sqrt(reps)
    check(tag, "|mean LML - Kalman LML| - 5*SE",
          abs(lml.mean() - float(lml_exact)) - 5 * se_l, "<= 0.05",
          abs(lml.mean() - float(lml_exact)) <= 5 * se_l + 0.05)


def sharded_phase(n_devices=4, per_device=1_000_000, T=10):
    """One SMC step sharded over ``n_devices`` cards against the same step
    on one card with ``n_blocks=n_devices`` and no mesh."""
    from genparticlefilters_tpu.models.object_motion import (
        make_object_motion, init_state, obs_at_t)
    from genparticlefilters_tpu.parallel import (
        particle_mesh, shard_state, pf_resample_blockwise, pf_rotate_blocks)
    devices = jax.devices()[:n_devices]
    assert len(devices) == n_devices, f"need {n_devices} devices"
    n = per_device * n_devices
    y_obs, _ = synthesize_data(jr.key(42), T, 5)
    model = make_object_motion(T)
    x0 = init_state()
    mesh = particle_mesh(devices)

    def step(key, s, mesh):
        k1, k2, k3, k4 = jr.split(key, 4)
        s = g.pf_update(k1, s, (2, x0), (g.UnknownChange(),),
                        obs_at_t(y_obs, 1), check=False)
        ess = g.effective_sample_size(s)

        def resample(s):
            s = pf_resample_blockwise(k2, s, n_devices, method="systematic",
                                      mesh=mesh)
            return pf_rotate_blocks(s, n_devices, 1, mesh=mesh)

        s = jax.lax.cond(ess < 0.75 * n, resample, lambda x: x, s)
        steps = jnp.arange(T)
        sel = g.Selection({("moving",): steps <= 1, ("y",): steps <= 1})
        s = g.pf_rejuvenate(k3, s, g.mh, (sel,))
        s = g.pf_resample(k4, s, "systematic", check=False)
        return s, ess, g.log_ml_estimate(s)

    with jax.default_device(devices[0]):
        state = jax.jit(lambda k: g.pf_initialize(
            k, model, (1, x0), obs_at_t(y_obs, 0), n))(jr.key(0))
    tag = f"sharded step N={n} over {n_devices} cards"
    one = compile_fn(lambda k, s: step(k, s, None), jr.key(1), state)
    res = one(jr.key(1), state)
    ess1, lml1 = float(res[1]), float(res[2])
    sharded = shard_state(state, mesh)
    del state, res
    t0 = time.perf_counter()
    many = compile_fn(lambda k, s: step(k, s, mesh), jr.key(1), sharded)
    out, ess, lml = jax.block_until_ready(many(jr.key(1), sharded))
    print(f"[{tag}] wall {time.perf_counter() - t0:.2f}s (compile + run); "
          + memory_line(many), flush=True)
    check(tag, "global ESS rel. diff vs one card",
          abs(float(ess) - ess1) / ess1, "<= 1e-4",
          abs(float(ess) - ess1) <= 1e-4 * ess1)
    check(tag, "LML diff vs one card", abs(float(lml) - lml1),
          "<= 1e-4 * max(1, |LML|)",
          abs(float(lml) - lml1) <= 1e-4 * max(1.0, abs(lml1)))
    spans = [len(l.sharding.device_set) for l in jax.tree_util.tree_leaves(
        out.traces) if l.ndim >= 1 and n in l.shape]
    check(tag, "devices spanned by each particle leaf", sorted(set(spans)),
          f"all {n_devices}", spans and set(spans) == {n_devices})
    del sharded
    stats = [d.memory_stats() for d in devices]
    if devices[0].platform == "cpu" and None in stats:
        print(f"  [{tag}] bytes_in_use per device: not reported by the CPU "
              "backend", flush=True)
        return
    used = [st["bytes_in_use"] for st in stats]
    print(f"  [{tag}] bytes_in_use per card: {used}", flush=True)
    spread = (max(used) - min(used)) / max(used)
    check(tag, "bytes_in_use spread across cards", spread, "<= 0.10",
          spread <= 0.10)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    use_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"jax {jax.__version__}; {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    if args.devices == 4:
        phases = [sharded_phase]
    else:
        phases = [kernel_phase, headline_phase, resampling_phase,
                  config5_phase, config2_phase]
    t_all = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"{phase.__name__}: ok in {time.perf_counter() - t0:.1f}s",
              flush=True)
    print(f"all phases ok in {time.perf_counter() - t_all:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
