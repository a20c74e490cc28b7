"""Derive the docs/parallel.md communication-volume table from compiled
HLO: lower every distributed phase of the flagship config over a 4-device
mesh and count the collective instructions and their byte volumes.

Runs on 4 virtual CPU devices (the shapes and the SPMD partitioning are
those of a 4-card mesh; no time is modelled or measured). Usage:

    python scripts/ici_table.py            # print the table
    python scripts/ici_table.py --write    # also splice it into docs/parallel.md
"""

import os
import re
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as g  # noqa: E402
from genparticlefilters_tpu.models.object_motion import (  # noqa: E402
    make_object_motion, init_state, obs_at_t)
from genparticlefilters_tpu.parallel import (  # noqa: E402
    particle_mesh, state_pspecs, pf_resample_blockwise, pf_rotate_blocks,
    pf_shuffle_blocks)
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

N = 1 << 20          # 1M particles (north-star workload, BASELINE.json)
T = 10
K = 4                # one host of four cards

_DTYPE_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
                "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}

_COLLECTIVES = ("collective-permute", "all-gather", "all-to-all",
                "all-reduce", "reduce-scatter")


def collective_bytes(hlo_text):
    """{op: (count, result_bytes)} summed over all instances in the
    optimized (SPMD-partitioned, per-device) HLO module."""
    out = {op: [0, 0] for op in _COLLECTIVES}
    pat = re.compile(
        r"=\s+(\(?.*?\)?)\s+(" + "|".join(_COLLECTIVES) + r")(-start)?\(")
    shape_pat = re.compile(r"(\w+)\[([\d,]*)\]")
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        shapes, op = m.group(1), m.group(2)
        nbytes = 0
        for dt, dims in shape_pat.findall(shapes):
            if dt not in _DTYPE_BYTES:
                continue
            size = 1
            for d in dims.split(","):
                if d:
                    size *= int(d)
            nbytes += size * _DTYPE_BYTES[dt]
        out[op][0] += 1
        out[op][1] += nbytes
    return {op: tuple(v) for op, v in out.items() if v[0]}


def fmt_bytes(b):
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f} MB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f} KB"
    return f"{b} B"


def main(write=False):
    mesh = particle_mesh(jax.devices()[:K])
    model = make_object_motion(T)
    y = jnp.linspace(0.0, 1.0, T).astype(jnp.float32)

    state_sds = jax.eval_shape(
        lambda k: g.pf_initialize(k, model, (1, init_state()),
                                  obs_at_t(y, 0), N), jr.key(0))
    shardings = jax.tree_util.tree_map(
        lambda ps: NamedSharding(mesh, ps), state_pspecs(state_sds),
        is_leaf=lambda x: isinstance(x, P))
    s_arg = jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        state_sds, shardings)
    key_sds = jax.ShapeDtypeStruct(
        jax.eval_shape(lambda: jr.key(0)).shape,
        jax.eval_shape(lambda: jr.key(0)).dtype,
        sharding=NamedSharding(mesh, P()))

    phases = [
        ("extension update (`Extend(1)`)", "every step",
         lambda: jax.jit(lambda k, s: g.pf_update(
             k, s, (2, init_state()), (g.UnknownChange(),),
             obs_at_t(y, 1), check=False)).lower(key_sds, s_arg)),
        ("ESS / LML diagnostics", "every step",
         lambda: jax.jit(lambda s: (g.effective_sample_size(s),
                                    g.log_ml_estimate(s))).lower(s_arg)),
        ("`pf_resample_blockwise` (shard_map)", "on ESS trigger",
         lambda: jax.jit(lambda k, s: pf_resample_blockwise(
             k, s, K, method="systematic", mesh=mesh)).lower(key_sds,
                                                             s_arg)),
        ("`pf_rotate_blocks(shift=1)` (shard_map)", "after block resample",
         lambda: jax.jit(lambda s: pf_rotate_blocks(
             s, K, 1, mesh=mesh)).lower(s_arg)),
        ("`pf_shuffle_blocks` (shard_map)", "periodic decorrelation",
         lambda: jax.jit(lambda s: pf_shuffle_blocks(
             s, K, mesh=mesh)).lower(s_arg)),
        ("global `pf_resample` (GSPMD)", "exact global ancestry only",
         lambda: jax.jit(lambda k, s: g.pf_resample(
             k, s, "systematic", check=False)).lower(key_sds, s_arg)),
    ]

    rows = []
    for name, when, lower in phases:
        print(f"[ici_table] compiling {name} ...", file=sys.stderr)
        txt = lower().compile().as_text()
        found = collective_bytes(txt)
        if not found:
            rows.append((name, "none", "0", when))
            continue
        for op, (cnt, nbytes) in sorted(found.items(),
                                        key=lambda kv: -kv[1][1]):
            rows.append((name, f"{cnt}× `{op}`", fmt_bytes(nbytes), when))
            name = "  \"" + ""  # continuation rows

    lines = [
        "| phase | collective instructions (compiled HLO) | "
        "result bytes/device | when |",
        "|---|---|---|---|",
    ]
    for r in rows:
        lines.append("| " + " | ".join(r) + " |")
    lines.append("")
    lines.append(
        f"Both columns are read from the compiled per-device HLO of a "
        f"{K}-device mesh at N={N}; collective times are not measured.")
    table = "\n".join(lines)
    print(table)

    if write:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "docs", "parallel.md")
        with open(path) as f:
            doc = f.read()
        start, end = "<!-- ici-table-start -->", "<!-- ici-table-end -->"
        i, j = doc.index(start), doc.index(end)
        doc = doc[:i + len(start)] + "\n" + table + "\n" + doc[j:]
        with open(path, "w") as f:
            f.write(doc)
        print(f"[ici_table] wrote table into {path}", file=sys.stderr)


if __name__ == "__main__":
    main(write="--write" in sys.argv)
