"""Config-3 benchmark: stochastic volatility, N=100K, T=100,
ESS-triggered systematic resampling + move-reweight rejuvenation."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
from genparticlefilters_tpu.utils.compile_cache import use_compile_cache
use_compile_cache()
import jax.numpy as jnp, jax.random as jr, numpy as np
from functools import partial
from jax import lax
from genparticlefilters_tpu.models.stochastic_volatility import (
    SVParams, sv_particle_filter, synthesize_sv_data)

N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
T = int(sys.argv[2]) if len(sys.argv) > 2 else 100
W = int(sys.argv[3]) if len(sys.argv) > 3 else 2
p = SVParams()
print("device:", jax.devices()[0], f" N={N} T={T} window={W}", flush=True)
y = synthesize_sv_data(jr.key(3), T, p)

@partial(jax.jit, static_argnums=(1,))
def many(key0, k):
    def body(acc, kk):
        st = sv_particle_filter(kk, y, N, T, p, rejuv_window=W)
        from genparticlefilters_tpu.smc.state import log_ml_estimate
        return acc + log_ml_estimate(st), None
    acc, _ = lax.scan(body, jnp.asarray(0.0, jnp.float32),
                      jr.split(key0, k))
    return acc

t0 = time.time()
for k in (1, 5):
    v = float(np.asarray(many(jr.key(0), k)))
print(f"compile+first: {time.time()-t0:.1f}s (lml accum {v:.2f})", flush=True)
best = 1e9
for _ in range(3):
    t0 = time.time(); _ = float(np.asarray(many(jr.key(1), 1))); e1 = time.time() - t0
    t0 = time.time(); _ = float(np.asarray(many(jr.key(1), 5))); e5 = time.time() - t0
    best = min(best, (e5 - e1) / 4)
print(f"SV filter: {best*1e3:.1f} ms/run -> {N*T/best:,.0f} updates/s", flush=True)
