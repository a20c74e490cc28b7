"""BASELINE configs 4 and 5: measured single-chip numbers.

Config 4 — SMC over a model sequence (tempered annealing), N=100K
particles x 50 temperatures with 2-sweep MH rejuvenation on ESS triggers;
metric = particle-(re)weight updates/s = N*(n_temps-1)/time. The headline
path realizes the translator semantics as an args-update (weight =
Δscore, docstring at smc/algorithms.py:76); the SMCP³
UpdatingTraceTranslator path (auxiliary variables + masked-branch
transform) is measured separately at the same shapes it is tested at.

Config 5 — multi-object tracking (K=4 objects, [K,2] sites), N=1M
particles, T=10, ESS-triggered systematic resampling, with ONLINE
RESIZING: every filter runs a mid-stream pf_resize 1M -> 500K -> 1M
(residual), exercising the resize path at full scale on the chip.

Usage: python scripts/config45_bench.py (writes chiprun_out/config45.json)
"""

import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from jax import lax

import genparticlefilters_tpu as g
from genparticlefilters_tpu.utils.compile_cache import use_compile_cache


def time_chained(tag, run_one, ks=(2, 22), reps=4, work=1):
    """run_one(key) -> scalar; chain k runs in one jit, rep-difference."""
    @partial(jax.jit, static_argnums=(1,))
    def many(key0, k):
        def body(acc, kk):
            return acc + run_one(kk), None
        acc, _ = lax.scan(body, jnp.asarray(0.0, jnp.float32),
                          jr.split(key0, k))
        return acc

    t0 = time.time()
    for k in ks:
        v = float(np.asarray(many(jr.key(0), k)))
    print(f"{tag}: compile+first {time.time()-t0:.1f}s (acc {v:.2f})",
          flush=True)
    best = 1e9
    for _ in range(reps):
        t0 = time.time(); _ = float(np.asarray(many(jr.key(1), ks[0]))); e1 = time.time() - t0
        t0 = time.time(); _ = float(np.asarray(many(jr.key(1), ks[1]))); e2 = time.time() - t0
        best = min(best, (e2 - e1) / (ks[1] - ks[0]))
    ups = work / best
    print(f"{tag}: {best*1e3:.1f} ms/run -> {ups:,.0f} updates/s", flush=True)
    _RESULTS.append({"config": tag, "ms_per_run": round(best * 1e3, 2),
                     "updates_per_s": round(ups)})
    return best


_RESULTS = []


def config4():
    from genparticlefilters_tpu.models.tempered import run_tempered_smc
    N, K = 100_000, 50

    def run_one(key):
        _, lml = run_tempered_smc(key, N, n_temps=K, rejuv_iters=2)
        return lml

    time_chained(f"config4 tempered N={N} temps={K}", run_one,
                 work=N * (K - 1))


def config4_smcp3(n=100_000, n_temps=50):
    """SMCP³ translator path (fwd+bwd auxiliary proposals + deterministic
    transform) at the FULL config-4 scale: with the model and both
    proposals marked batch_safe, pf_update(translator=...) runs ONE
    batched interpretation through simulate+transform+update+generate
    (smc/update.py), so the translator path is measured at the same
    N=100K x 50 temperatures as the args-update shortcut."""
    from genparticlefilters_tpu.models.tempered import make_tempered_model
    from genparticlefilters_tpu.core import gen, trace, normal
    from genparticlefilters_tpu.core.choicemap import ChoiceMap, Entry
    model = make_tempered_model()
    betas = jnp.linspace(0.0, 1.0, n_temps) ** 2

    @gen
    def fwd(tr):
        trace("eps", normal(0.0, 0.25))

    @gen
    def bwd(tr):
        trace("eps", normal(0.0, 0.25))

    fwd.batch_safe = True
    bwd.batch_safe = True

    def transform_fn(prev, fwd_ch):
        eps = fwd_ch[("eps",)]
        x = prev[("x",)]
        return (ChoiceMap({("x",): Entry(x + eps, True)}),
                ChoiceMap({("eps",): Entry(-eps, True)}))

    def run_one(key):
        k0, kloop = jr.split(key)
        st = g.pf_initialize(k0, model, (betas[0],), g.choicemap(), n)

        def step(st, inp):
            i, beta = inp
            kt = jr.fold_in(kloop, i)
            tr = g.UpdatingTraceTranslator(
                p_new_args=(beta,),
                p_argdiffs=(g.UnknownChange(),),
                new_observations=g.EMPTY,
                q_forward=fwd, q_backward=bwd,
                transform=g.TraceTransform(transform_fn))
            st = g.pf_update(kt, st, translator=tr, check=False)
            return st, None

        idxs = jnp.arange(1, n_temps, dtype=jnp.int32)
        st, _ = lax.scan(step, st, (idxs, betas[1:]))
        return g.log_ml_estimate(st)

    time_chained(f"config4 SMCP3 translator (batched) N={n} temps={n_temps}",
                 run_one, ks=(2, 12), work=n * (n_temps - 1))


def config5(N=1_000_000, T=10):
    from genparticlefilters_tpu.models.multi_object import (
        MOTParams, make_mot_model, mot_obs_dense, synthesize_mot_data)
    from genparticlefilters_tpu.core import Extend, NoChange
    p = MOTParams()
    y = synthesize_mot_data(jr.key(5), T, p)
    model = make_mot_model(T, p)
    x0 = jnp.zeros((p.n_objects, 2), jnp.float32)

    def run_one(key):
        k0, kloop = jr.split(key)
        obs = mot_obs_dense(y)
        st = g.pf_initialize(k0, model, (1, x0), obs, N)

        def make_step(n_now):
            def step(st, t):
                kt = jr.fold_in(kloop, t)
                kr, ku = jr.split(kt)

                def resample(s):
                    return g.pf_resample(kr, s, "systematic", check=False)

                ess = g.effective_sample_size(st)
                s = lax.cond(ess < 0.5 * n_now, resample, lambda s: s, st)
                s = g.pf_update(ku, s, (t + 1, x0), (Extend(1), NoChange()),
                                obs, check=False)
                return s, None
            return step

        # online resizing: full -> half -> full mid-stream (static shapes
        # per segment; the reference's resize! reallocates, we re-jit per
        # size — spec: /root/reference/src/resize.jl:16-27)
        t1, t2 = T // 3, 2 * T // 3
        st, _ = lax.scan(make_step(N), st,
                         jnp.arange(1, t1, dtype=jnp.int32))
        st = g.pf_resize(jr.fold_in(kloop, 1001), st, N // 2, "residual", check=False)
        st, _ = lax.scan(make_step(N // 2), st,
                         jnp.arange(t1, t2, dtype=jnp.int32))
        st = g.pf_resize(jr.fold_in(kloop, 1002), st, N, "multinomial", check=False)
        st, _ = lax.scan(make_step(N), st,
                         jnp.arange(t2, T, dtype=jnp.int32))
        return g.log_ml_estimate(st)

    time_chained(f"config5 MOT+resize N={N} T={T}", run_one, ks=(1, 5),
                 work=N * T)


def main():
    use_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {len(jax.devices())} x {dev.device_kind}", flush=True)
    config4()
    config4_smcp3()
    config5()
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "config45.json")
    with open(path, "w") as f:
        json.dump({"device_kind": dev.device_kind,
                   "device_count": len(jax.devices()),
                   "rows": _RESULTS}, f, indent=1)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
