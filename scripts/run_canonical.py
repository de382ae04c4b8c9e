"""Run the canonical configs/params.txt end-to-end and record the result.

Usage:
    python scripts/run_canonical.py out.json [key=value overrides ...]

Runs the full nonlinear solve (the reference driver's poissonSolve,
Main_PoissonSolver.cpp:45-256) on the current backend and writes a JSON
record with the Picard dpsi-norm history, linear iteration counts, timing
split (compile wall vs steady per-iteration), and convergence status —
the record format of docs/canonical_7level_result.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)
from mg_ic_code_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure()

REFERENCE_PARAMS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "params.txt",
)


def main() -> int:
    out_path = sys.argv[1]
    overrides = sys.argv[2:]

    from mg_ic_code_tpu.config import load_params
    from mg_ic_code_tpu.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu.solver.nonlinear import poisson_solve

    cfg = load_params(REFERENCE_PARAMS, overrides=overrides)
    geom = generate_hierarchy(cfg)
    levels = [
        [list(geom.boxes[e].shape) for e in geom.entries_at_depth(d)]
        for d in range(geom.max_depth + 1)
    ]
    print(f"hierarchy: {levels}", file=sys.stderr)

    iter_times: list[float] = []
    t_prev = time.perf_counter()

    def hook(nl_iter, state):
        nonlocal t_prev
        now = time.perf_counter()
        if nl_iter > 0:
            iter_times.append(now - t_prev)
        t_prev = now

    t0 = time.perf_counter()
    res = poisson_solve(cfg, geom=geom, verbose=True, output_hook=hook)
    total = time.perf_counter() - t0
    # the first iteration carries the compile; later ones are steady state
    steady = min(iter_times[1:]) if len(iter_times) > 1 else None

    record = {
        "history": [float(h) for h in res.dpsi_norm_history],
        "linear_iters": [int(i) for i in res.linear_iters],
        "converged": bool(res.converged),
        "constant_K": float(res.constant_K),
        "total_s": round(total, 2),
        "steady_s_per_iter": round(steady, 3) if steady else None,
        "backend": jax.default_backend(),
        "device": jax.devices()[0].device_kind,
        "overrides": overrides,
        "levels": levels,
    }
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), file=sys.stderr)
    return 0 if res.converged else 2


if __name__ == "__main__":
    sys.exit(main())
