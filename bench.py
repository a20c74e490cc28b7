"""Benchmark: particle-updates/sec/chip at 100K particles (BASELINE.json
metric) on the README object-motion switching SSM (config 1 scaled up).

Measures the full jitted SMC filter — per-step trace-extension update +
ESS-triggered systematic resampling + MH rejuvenation — end to end on the
GPU (it refuses to run on any other platform), and compares against a faithful
vectorized NumPy implementation of the same filter on the host CPU
(a favorable stand-in for the reference's serial per-particle Julia loops,
which it strictly upper-bounds). README posterior-parity (residual + MH,
config 1) is covered by the test suite; systematic is the standard
throughput configuration (BASELINE config 2/3).

Prints the device kind and the ``nvidia-smi`` name/power-limit line, then
ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import math
import os
import subprocess
import sys
import time

N = int(os.environ.get("GPF_BENCH_N", 100_000))
T = int(os.environ.get("GPF_BENCH_T", 10))
SEED = 7


def theil_sen(points):
    """Median-of-pairwise-slopes line fit over (k, elapsed) points — robust
    to dispatch and host-fetch jitter, which corrupts any single differenced
    pair."""
    slopes = []
    pts = sorted(points)
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            (k1, e1), (k2, e2) = pts[i], pts[j]
            if k2 != k1:
                slopes.append((e2 - e1) / (k2 - k1))
    slopes.sort()
    m = len(slopes)
    return (slopes[m // 2] if m % 2 else
            0.5 * (slopes[m // 2 - 1] + slopes[m // 2]))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# NumPy baseline: same model, same algorithm, vectorized on host CPU
# ---------------------------------------------------------------------------

def numpy_filter(y_obs, n, rng):
    import numpy as np

    def lpnorm(x, mu, s):
        return -0.5 * ((x - mu) / s) ** 2 - math.log(s) \
            - 0.5 * math.log(2 * math.pi)

    t_total = len(y_obs)
    moving = np.zeros((n, t_total), dtype=bool)
    y = np.zeros((n, t_total), dtype=np.float64)
    lw = np.zeros(n)

    def sim_step(t, prev_m, prev_y):
        p = np.where(prev_m, 0.75, 0.25)
        m = rng.random(n) < p
        vel = np.where(m, math.sin(t + 1), 0.0)
        yy = prev_y + vel + 0.01 * rng.standard_normal(n)
        return m, yy

    def systematic_parents(w):
        cum = np.cumsum(w)
        u = (np.arange(n) + rng.random()) / n
        return np.clip(np.searchsorted(cum, u, side="left"), 0, n - 1)

    m0, y0 = sim_step(0, np.zeros(n, bool), np.zeros(n))
    moving[:, 0], y[:, 0] = m0, y0
    lw += lpnorm(y_obs[0], y0, 0.25)

    for t in range(1, t_total):
        # ESS check
        w = np.exp(lw - lw.max())
        w /= w.sum()
        ess = 1.0 / np.sum(w ** 2)
        if ess < 0.5 * n:
            parents = systematic_parents(w)
            moving, y = moving[parents], y[parents]
            lw = np.zeros(n)
            # MH rejuvenation on (moving, y) at t-1 (vectorized regenerate)
            tm1 = t - 1
            prev_m = moving[:, tm1 - 1] if tm1 > 0 else np.zeros(n, bool)
            prev_y = y[:, tm1 - 1] if tm1 > 0 else np.zeros(n)
            new_m, new_y = sim_step(tm1, prev_m, prev_y)
            d = lpnorm(y_obs[tm1], new_y, 0.25) - lpnorm(
                y_obs[tm1], y[:, tm1], 0.25)
            accept = np.log(rng.random(n)) < d
            moving[accept, tm1] = new_m[accept]
            y[accept, tm1] = new_y[accept]
        # propagate + reweight
        m, yy = sim_step(t, moving[:, t - 1], y[:, t - 1])
        moving[:, t], y[:, t] = m, yy
        lw += lpnorm(y_obs[t], yy, 0.25)
    return lw


def main():
    import numpy as np

    import jax
    import jax.numpy as jnp
    import jax.random as jr

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from genparticlefilters_tpu.models.object_motion import (
        object_motion_filter_impl, synthesize_data)
    from genparticlefilters_tpu.utils.compile_cache import use_compile_cache
    from functools import partial
    from jax import lax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    use_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()

    y_obs, _ = synthesize_data(jr.key(42), T, 5)

    # K filter runs chained in ONE jitted executable (lax.scan over keys):
    # a single dispatch + a single scalar host fetch per timing sample, so
    # the fixed dispatch/fetch latency appears exactly once per sample and
    # is cancelled by the slope fit over several K values.
    @partial(jax.jit, static_argnums=(1,))
    def filter_many(key0, k):
        keys = jr.split(key0, k)

        def body(acc, kk):
            st = object_motion_filter_impl(kk, y_obs, N, T, 0.5,
                                           "systematic")
            return acc + st.log_ml_est, None

        acc, _ = lax.scan(body, jnp.asarray(0.0, jnp.float32), keys)
        return acc

    KS = (3, 23, 43)
    t0 = time.time()
    for k in KS:  # compile all shapes (persistent cache makes reruns fast)
        _ = float(np.asarray(filter_many(jr.key(SEED), k)))
    log(f"compile+first runs: {time.time() - t0:.1f}s")

    def sample_k(k, seed):
        t0 = time.time()
        jax.block_until_ready(filter_many(jr.key(seed), k))
        return time.time() - t0

    def measure(n_samples):
        mins = {k: float("inf") for k in KS}
        seed = 1000
        for _ in range(n_samples):
            for k in KS:  # interleave so drift hits every k equally
                mins[k] = min(mins[k], sample_k(k, seed))
                seed += 1
        pts = sorted(mins.items())
        per_run = theil_sen(pts)
        # spread: compare the two independent adjacent-pair slopes
        s01 = (pts[1][1] - pts[0][1]) / (pts[1][0] - pts[0][0])
        s12 = (pts[2][1] - pts[1][1]) / (pts[2][0] - pts[1][0])
        spread = abs(s01 - s12) / max(abs(per_run), 1e-12)
        log(f"  min elapsed per k: "
            + ", ".join(f"k={k}: {e:.3f}s" for k, e in pts)
            + f" -> slope {per_run*1e3:.2f}ms/run (spread {spread:.2f})")
        return per_run, spread

    per_run = None
    for attempt in range(4):
        cand, spread = measure(n_samples=4 + 2 * attempt)
        if cand > 0 and spread < 0.25:
            per_run = cand
            break
        log(f"  measurement attempt {attempt} rejected "
            f"(per_run={cand*1e3:.2f}ms, spread={spread:.2f}); retrying")
    if per_run is None:
        per_run = cand  # last attempt, report it but flag loudly
        log("WARNING: timing never converged; reporting last estimate")
    assert per_run > 0, f"non-positive per-run time {per_run}"
    ups = N * T / per_run
    log(f"framework: per-run {per_run*1e3:.2f}ms -> "
        f"{ups:,.0f} particle-updates/s")

    # NumPy CPU baseline (1 run is enough; it is deterministic in cost)
    yo = np.asarray(y_obs, np.float64)
    rng = np.random.default_rng(0)
    t0 = time.time()
    numpy_filter(yo, N, rng)
    base_elapsed = time.time() - t0
    base_ups = N * T / base_elapsed
    log(f"numpy baseline: {base_elapsed:.3f}s -> "
        f"{base_ups:,.0f} particle-updates/s")

    print(f"device: {len(jax.devices())} x {dev.device_kind}", flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "metric": f"particle-updates/sec/chip ({dev.device_kind}), object-motion"
                  f" SSM, {N} particles, T={T}, ESS-triggered systematic "
                  "resampling + MH rejuvenation",
        "value": round(ups, 1),
        "unit": "particle-updates/s",
        "vs_baseline": round(ups / base_ups, 3),
    }))


if __name__ == "__main__":
    main()
