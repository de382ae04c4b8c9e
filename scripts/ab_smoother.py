"""Fused GPU smoother kernel against the XLA smoother body, on one GPU.

Usage: python scripts/ab_smoother.py [out.json]

Three measurements, each taken in turns within this one process (kernel,
XLA, XLA, kernel, ...) so that clock and power drift fall on both sides:

  * layer: ms per red+black sweep of multigrid's smoother on one level
    (4 sweeps per call, the V-cycle's numMGsmooth) at 256^3 and at the
    flagship's two largest level shapes (960x144x144, 512x96x96), in f64
    and f32; beside each time, the least time the 3.35 TB/s HBM bound
    allows for the streams each version must move per sweep (kernel:
    read u, rhs, aCoef, lambda and write u once; XLA: the same per colour);
  * tiles: the kernel alone at 256^3 and 512x96x96 f64 with several (by, bz)
    tiles, each with the seconds its first call took (trace + compile);
  * end to end: the 7-level flagship (configs/params.txt, f64) through
    nonlinear.poisson_solve with smoother = auto (kernel) and = xla,
    as median steady seconds per Picard iteration (iterations 2..), with
    the two Picard histories.

Prints one JSON line (also written to out.json when given) naming the
device, its kind, the device count and the card's power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from mg_ic_code_tpu.utils import compile_cache  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PARAMS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "params.txt",
)


def power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def layer(shape, dtype, nsweeps=4, reps=5):
    from mg_ic_code_tpu.grid.geometry import BCSpec, single_level_geom
    from mg_ic_code_tpu.solver import multigrid as mg

    geom = single_level_geom(shape, 1.0, BCSpec())
    out = {}
    fns = {}
    for smoother in ("auto", "xla"):
        spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0,
                                  nsmooth=nsweeps, with_depths=False,
                                  smoother=smoother)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        a = jax.random.uniform(k1, shape, dtype, 0.5, 2.0)
        coefs = mg.build_level_coefs_jit(spec, a)
        rhs = jax.random.normal(k2, shape, dtype)
        u = jax.random.normal(k3, shape, dtype)
        fns[smoother] = (spec, coefs, u, rhs)
        mg.relax_jit(spec, coefs, 0, u, rhs, nsweeps).block_until_ready()
    times = {"auto": [], "xla": []}
    for order in (("auto", "xla"), ("xla", "auto")) * reps:
        for name in order:
            spec, coefs, u, rhs = fns[name]
            t0 = time.perf_counter()
            mg.relax_jit(spec, coefs, 0, u, rhs, nsweeps).block_until_ready()
            times[name].append(time.perf_counter() - t0)
    cells = shape[0] * shape[1] * shape[2]
    item = jnp.dtype(dtype).itemsize
    for name, streams in (("auto", 5), ("xla", 10)):
        ms = statistics.median(times[name]) / nsweeps * 1e3
        bound_ms = streams * cells * item / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms_per_sweep": ms, "bytes_bound_ms": bound_ms,
                     "bound_share": bound_ms / ms}
    return out


def tiles(shapes=((256, 256, 256), (512, 96, 96)),
          cands=((16, 16), (8, 32), (8, 64), (16, 32)), nsweeps=4, reps=5):
    from mg_ic_code_tpu.ops import gsrb_gpu
    from mg_ic_code_tpu.ops import stencils as st

    out = {}
    for shape in shapes:
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
        a = jax.random.uniform(k1, shape, jnp.float64, 0.5, 2.0)
        rhs = jax.random.normal(k2, shape, jnp.float64)
        u = jax.random.normal(k3, shape, jnp.float64)
        lam = st.gsrb_lambda(a, 1.0, -1.0, 1.0 / shape[0])
        kinds = (("dirichlet", "dirichlet"),) * 3

        def run(tile):
            return gsrb_gpu.gsrb_relax(
                u, rhs, a, lam, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
                dx=1.0 / shape[0], lo=(0, 0, 0), nsweeps=nsweeps, tile=tile,
            ).block_until_ready()

        first = {}
        for tile in cands:
            t0 = time.perf_counter()
            run(tile)
            first[tile] = time.perf_counter() - t0
        times = {tile: [] for tile in cands}
        for r in range(reps):
            order = cands if r % 2 == 0 else cands[::-1]
            for tile in order:
                t0 = time.perf_counter()
                run(tile)
                times[tile].append(time.perf_counter() - t0)
        out[f"{shape[0]}x{shape[1]}x{shape[2]}"] = {
            f"{tile[0]}x{tile[1]}": {
                "ms_per_sweep": statistics.median(times[tile]) / nsweeps * 1e3,
                "first_call_s": first[tile],
            }
            for tile in cands
        }
    return out


def end_to_end():
    from mg_ic_code_tpu.config import load_params
    from mg_ic_code_tpu.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu.solver.nonlinear import poisson_solve

    cfg0 = load_params(PARAMS, overrides=["verbosity = 0"])
    geom = generate_hierarchy(cfg0)
    cfgs = {
        s: load_params(PARAMS, overrides=["verbosity = 0", f"smoother = {s}"])
        for s in ("auto", "xla")
    }
    runs = {"auto": [], "xla": []}
    for name in ("auto", "xla", "xla", "auto"):
        r = poisson_solve(cfgs[name], geom=geom, verbose=False)
        runs[name].append({
            "history": r.dpsi_norm_history,
            "linear_iters": r.linear_iters,
            "iter_seconds": r.iter_seconds,
        })
    out = {}
    for name, rs in runs.items():
        steady = [t for r in rs for t in r["iter_seconds"][1:]]
        out[name] = {
            "steady_s_per_iter": statistics.median(steady),
            "first_iter_s": [r["iter_seconds"][0] for r in rs],
            "runs": rs,
        }
    return out


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX runs on {dev.platform}", file=sys.stderr)
        return 2
    compile_cache.configure()
    card = power_limit()
    print(card, flush=True)
    rec = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), "card": card, "layer": {}}
    for shape in ((256, 256, 256), (960, 144, 144), (512, 96, 96)):
        for dtype in (jnp.float64, jnp.float32):
            key = f"{shape[0]}x{shape[1]}x{shape[2]} {jnp.dtype(dtype).name}"
            rec["layer"][key] = layer(shape, dtype)
            print(key, json.dumps(rec["layer"][key]), flush=True)
    rec["tiles"] = tiles()
    print("tiles", json.dumps(rec["tiles"]), flush=True)
    rec["end_to_end"] = end_to_end()
    for name, r in rec["end_to_end"].items():
        print(f"flagship smoother={name}: steady s/iter "
              f"{r['steady_s_per_iter']:.6f}, first iterations "
              f"{r['first_iter_s']}, history {r['runs'][0]['history']}",
              flush=True)
    line = json.dumps(rec)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
