"""Weak-scaling harness (BASELINE.json: scaling efficiency 1 -> N chips).

Runs the full sharded SMC step (extend-update + shard-local systematic
resampling + ring rotation + global ESS/LML) at a fixed per-device particle
count and reports throughput at 1 device vs all devices — weak-scaling
efficiency = thr(N)/ (N * thr(1)).

On several GPUs this measures multi-card scaling; on virtual CPU devices
it only validates the harness mechanics (virtual devices share host cores,
so the efficiency number means nothing there):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python bench_scaling.py

Prints one JSON line.
"""

import json
import os
import sys
import time


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp
    import jax.random as jr
    from jax import lax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from genparticlefilters_tpu.utils.compile_cache import use_compile_cache
    use_compile_cache()
    import genparticlefilters_tpu as g
    from genparticlefilters_tpu.models.object_motion import (
        make_object_motion, init_state, obs_at_t, synthesize_data)
    from genparticlefilters_tpu.parallel import (
        particle_mesh, shard_state, pf_resample_blockwise, pf_rotate_blocks)

    T = 10
    per_device = int(os.environ.get("BENCH_PER_DEVICE", 65536))
    devices = jax.devices()
    y_obs, _ = synthesize_data(jr.key(42), T, 5)
    model = make_object_motion(T)
    x0 = init_state()

    def make_step(n_blocks, n, mesh):
        def smc_step(key, s, t):
            k1, k2, k3 = jr.split(key, 3)
            s = g.pf_update(k1, s, (t + 1, x0),
                            (g.Extend(1), g.NoChange()),
                            obs_at_t(y_obs, t), check=False)
            ess = g.effective_sample_size(s)

            def resample(s):
                # explicit shard_map collectives when multi-device
                m = mesh if n_blocks > 1 else None
                s = pf_resample_blockwise(k2, s, n_blocks,
                                          method="systematic", mesh=m)
                if n_blocks > 1:
                    s = pf_rotate_blocks(s, n_blocks, 1, mesh=mesh)
                return s

            s = lax.cond(ess < 0.5 * n, resample, lambda x: x, s)
            return s
        return jax.jit(smc_step)

    def measure(n_devices):
        n = per_device * n_devices
        mesh = particle_mesh(devices[:n_devices])
        state = g.pf_initialize(jr.key(0), model, (1, x0),
                                obs_at_t(y_obs, 0), n)
        state = shard_state(state, mesh)
        step = make_step(n_devices, n, mesh)
        s = step(jr.key(1), state, jnp.asarray(1, jnp.int32))
        _ = np.asarray(s.log_ml_est)  # force completion

        def run_k(k, base):
            t0 = time.time()
            s = state
            for i in range(k):
                s = step(jr.fold_in(jr.key(2), base + i), s,
                         jnp.asarray(1 + (i % (T - 1)), jnp.int32))
            _ = float(np.asarray(s.log_ml_est))
            return time.time() - t0

        e1 = min(run_k(4, 0), run_k(4, 50))
        e2 = min(run_k(24, 100), run_k(24, 200))
        per_step = max((e2 - e1) / 20, 1e-9)
        return n / per_step  # particle-updates per second (1 step each)

    thr1 = measure(1)
    thrN = measure(len(devices))
    eff = thrN / (len(devices) * thr1)
    print(json.dumps({
        "metric": f"weak-scaling efficiency 1->{len(devices)} devices, "
                  f"{per_device} particles/device, sharded SMC step",
        "value": round(eff, 4),
        "unit": "efficiency",
        "vs_baseline": round(eff / 0.85, 3),  # target >= 85% (BASELINE.json)
        "device_kind": devices[0].device_kind,
        "throughput_1": round(thr1, 1),
        "throughput_N": round(thrN, 1),
        "n_devices": len(devices),
    }))


if __name__ == "__main__":
    main()
