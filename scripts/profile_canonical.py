"""Steady-state phase breakdown of one canonical Picard iteration
(configs/params.txt).

Usage: python scripts/profile_canonical.py out.json [key=value overrides...]

This times each phase of nl_iteration separately on the current backend
(warm, compiled, with scalar-readback barriers):

  * prepare   — coefficient/rhs setup (set_a_coef/set_rhs formulas)
  * coefs     — depth-chain coarsening + lambda + dense bottom inverse
  * apply     — ONE composite operator application (per Krylov iteration:
                ghost fills + CF upsampling + 7-point apply, f64 XLA)
  * precond   — ONE preconditioner application (num_mg_iterations AMR
                V-cycles, f32 when mixed)
  * norm      — ONE composite max-norm reduction
  * solve     — the full linear solve (for cross-checking the sum)
  * finish    — psi update + convergence norm

The driver-side cost model: solve ~= iters * (apply + precond + ~4 norms
+ BiCGStab axpys); whatever the phases do not explain is dispatch overhead.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)
from mg_ic_code_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure()

REFERENCE_PARAMS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "params.txt",
)


def barrier(x):
    leaves = jax.tree_util.tree_leaves(x)
    jax.block_until_ready(leaves)
    return float(jnp.sum(leaves[0]))


def timeit(fn, *args, reps: int = 3):
    out = fn(*args)
    barrier(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    barrier(out)
    return (time.perf_counter() - t0) / reps, out


def main() -> int:
    out_path = sys.argv[1]
    overrides = sys.argv[2:]

    from mg_ic_code_tpu.config import load_params
    from mg_ic_code_tpu.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu.physics import level_data as ld
    from mg_ic_code_tpu.solver import composite as comp
    from mg_ic_code_tpu.solver import nonlinear as nl
    from mg_ic_code_tpu.solver import reductions as red

    cfg = load_params(REFERENCE_PARAMS, overrides=overrides)
    geom = generate_hierarchy(cfg)
    spec = comp.make_amr_spec(geom, cfg)
    fields = [ld.problem_fields_jit(geom, cfg, l, jnp.float64)
              for l in range(geom.num_levels)]
    state = ld.initial_state(geom, cfg, jnp.float64)
    psi, dpsi = state["psi"], state["dpsi"]

    phases: dict[str, float] = {}

    t, (a_list, rhs_list, K) = timeit(
        lambda: nl.prepare_iteration_jit(geom, cfg, fields, psi)
    )
    phases["prepare"] = t
    t, coefs = timeit(lambda: comp.build_coefs_jit(spec, a_list))
    phases["coefs"] = t

    t, au = timeit(
        lambda: comp.composite_apply_jit(spec, coefs, rhs_list, True, False)
    )
    phases["apply"] = t
    t, _ = timeit(lambda: comp.precond_jit(spec, coefs, rhs_list))
    phases["precond"] = t

    norm_jit = jax.jit(
        lambda xs: red.composite_max_norm(xs, geom=geom), static_argnums=()
    )
    t, _ = timeit(lambda: norm_jit(rhs_list))
    phases["norm"] = t

    t, out = timeit(
        lambda: comp.solve_linear_jit(spec, coefs, rhs_list, dpsi), reps=1
    )
    phases["solve"] = t
    iters = int(out.iters)

    t, _ = timeit(
        lambda: nl.finish_iteration_jit(geom, psi, out.x, cfg.average_down)
    )
    phases["finish"] = t

    # the production path: prepare+coefs+solve+finish as ONE executable
    # (nl_iteration fused) — the staged sum above minus three dispatches
    t, _ = timeit(
        lambda: nl._fused_iteration_jit(spec, cfg, fields, psi, dpsi),
        reps=1,
    )
    phases["fused_iteration"] = t

    explained = iters * (
        phases["apply"] + phases["precond"] + 4 * phases["norm"]
    )
    record = {
        "phases_ms": {k: round(v * 1e3, 2) for k, v in phases.items()},
        "linear_iters": iters,
        "iteration_ms": round(
            (phases["prepare"] + phases["coefs"] + phases["solve"]
             + phases["finish"]) * 1e3, 2),
        "solve_explained_ms": round(explained * 1e3, 2),
        "solve_unexplained_ms": round((phases["solve"] - explained) * 1e3, 2),
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "overrides": overrides,
    }
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record, indent=1), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
