"""Run one of five benchmark configurations.

Usage: python benchmarks/run_config.py <1..5> [--small]

  1. Single-level constant-coefficient Poisson, 64^3 periodic box,
     point-source rhs (alpha=0, beta=-1).
  2. Variable-coefficient solve (aCoef from the psi^5 linearisation) on a
     single 128^3 grid, Picard outer loop.
  3. Full multigrid hierarchy (5 depths, 256^3 fine) with GSRB smoothing,
     restriction/prolongation, coarse bottom solve.
  4. Binary-black-hole Bowen-York initial data: full Hamiltonian-constraint
     solve with HDF5 output.
  5. Sharded solve over all local devices (block-partitioned levels,
     ppermute halos).

`--small` shrinks the grids for CPU smoke runs. Prints per-config JSON with
timings and convergence evidence.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mg_ic_code_tpu.config import SolverConfig  # noqa: E402
from mg_ic_code_tpu.grid.geometry import BCSpec, single_level_geom  # noqa: E402
from mg_ic_code_tpu.solver import composite as comp  # noqa: E402
from mg_ic_code_tpu.solver import multigrid as mg  # noqa: E402
from mg_ic_code_tpu.solver import reductions as red  # noqa: E402


def barrier(x):
    jax.block_until_ready(x)
    jnp.sum(jax.tree.leaves(x)[0]).item()


def config1(small: bool):
    """64^3 periodic Poisson with a (zero-mean) point source."""
    n = 32 if small else 64
    geom = single_level_geom(n, 1.0, BCSpec(periodic=True))
    cfg = SolverConfig(alpha=0.0, beta=-1.0, n_cells=(n, n, n), L=1.0,
                       is_periodic=True, num_mg_smooth=4, max_iterations=60,
                       tolerance=1e-10)
    spec = comp.make_amr_spec(geom, cfg)
    rhs = jnp.zeros((n, n, n)).at[n // 2, n // 2, n // 2].set(1.0)
    rhs = rhs - jnp.mean(rhs)  # integrability for the periodic Poisson eq
    coefs = comp.build_coefs_jit(spec, [jnp.zeros((n, n, n))])
    t0 = time.perf_counter()
    out = comp.solve_linear_jit(spec, coefs, [rhs], [jnp.zeros_like(rhs)])
    barrier(out.x)
    compile_and_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = comp.solve_linear_jit(spec, coefs, [rhs], [jnp.zeros_like(rhs)])
    barrier(out.x)
    dt = time.perf_counter() - t0
    return {
        "config": 1, "n": n, "iters": int(out.iters),
        "rel_residual": float(out.final_rnorm / out.initial_rnorm),
        "solve_s": dt, "first_call_s": compile_and_first,
    }


def config2(small: bool):
    """Variable-coefficient single-grid Picard loop."""
    from mg_ic_code_tpu.solver.nonlinear import poisson_solve

    n = 32 if small else 128
    cfg = SolverConfig(
        alpha=1.0, beta=-1.0, n_cells=(n, n, n), L=16.0, max_level=0,
        num_mg_smooth=4, num_mg_iterations=2, max_iterations=100,
        max_nl_iterations=6, tolerance=1e-10,
        bh1_bare_mass=0.2, bh2_bare_mass=0.2, bh1_offset=2.0,
        bh2_offset=-2.0, bh1_momentum=0.02, bh2_momentum=-0.02,
        bh1_spin=0.02, bh2_spin=0.02, phi_amplitude=0.05,
    )
    t0 = time.perf_counter()
    res = poisson_solve(cfg, verbose=False)
    dt = time.perf_counter() - t0
    return {
        "config": 2, "n": n, "history": res.dpsi_norm_history,
        "total_s": dt,
    }


def config3(small: bool):
    """Deep MG hierarchy V-cycles at the fine resolution."""
    n = 64 if small else 256
    geom = single_level_geom(n, 1.0, BCSpec())
    spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=4)
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.uniform(0.5, 2.0, (n, n, n)))
    coefs = mg.build_level_coefs_jit(spec, a)
    rhs = jnp.asarray(rng.standard_normal((n, n, n)))
    u = jnp.zeros_like(rhs)
    u = mg.mg_vcycle_jit(spec, coefs, u, rhs)
    barrier(u)
    r0 = float(jnp.max(jnp.abs(rhs)))
    t0 = time.perf_counter()
    ncyc = 5
    for _ in range(ncyc):
        u = mg.mg_vcycle_jit(spec, coefs, u, rhs)
    barrier(u)
    dt = (time.perf_counter() - t0) / ncyc
    r = float(jnp.max(jnp.abs(
        mg.residual_homog_jit(spec, coefs, 0, u, rhs))))
    return {
        "config": 3, "n": n, "depths": spec.ndepths,
        "vcycle_s": dt,
        "contraction_per_cycle": (r / r0) ** (1.0 / (ncyc + 1)),
    }


def config4(small: bool):
    """BBH Bowen-York initial data end-to-end with checkpoint output."""
    import tempfile

    from mg_ic_code_tpu.config import load_params
    from mg_ic_code_tpu.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu.io import chombo_hdf5 as io
    from mg_ic_code_tpu.solver.nonlinear import poisson_solve

    overrides = ["max_level = 1"] if small else ["max_level = 2"]
    cfg = load_params(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "params.txt"), overrides)
    t0 = time.perf_counter()
    geom = generate_hierarchy(cfg)
    res = poisson_solve(cfg, geom=geom, verbose=False)
    dt = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as td:
        io.write_final_data(f"{td}/final.hdf5", geom, cfg, res.psi,
                            res.fields, res.constant_K)
    return {
        "config": 4, "levels": geom.num_levels,
        "history": res.dpsi_norm_history, "total_s": dt,
    }


def config5(small: bool):
    """Sharded halo-exchange smoother over all local devices."""
    from mg_ic_code_tpu.parallel import halo, mesh as pmesh

    n = 64 if small else 256
    geom = single_level_geom(n, 1.0, BCSpec())
    spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=4)
    m = pmesh.make_mesh()
    sh = pmesh.level_sharding(geom, 0, m, min_local=2)
    rng = np.random.default_rng(0)
    a = jax.device_put(jnp.asarray(rng.uniform(0.5, 2.0, (n, n, n))), sh)
    coefs = mg.build_level_coefs_jit(spec, a)
    lam = jax.device_put(coefs["lam"][0], sh)
    rhs = jax.device_put(jnp.asarray(rng.standard_normal((n, n, n))), sh)
    u = jax.device_put(jnp.zeros((n, n, n)), sh)
    relax_fn, _ = halo.make_sharded_level_ops(spec, m, 0, nsweeps=4)
    f = jax.jit(relax_fn)
    u = f(a, lam, u, rhs)
    barrier(u)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        u = f(a, lam, u, rhs)
    barrier(u)
    dt = (time.perf_counter() - t0) / reps
    return {
        "config": 5, "n": n, "devices": len(jax.devices()),
        "relax4_s": dt,
        "dof_per_s": float(n) ** 3 * 4 / dt,
    }


def main():
    which = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    small = "--small" in sys.argv
    fn = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}[which]
    out = fn(small)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
