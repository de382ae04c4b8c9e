"""Outer nonlinear (Picard) loop: the poissonSolve driver.

JAX re-design of the reference driver (Main_PoissonSolver.cpp:45-256):
per iteration, optionally set the constant-K integrability condition
(periodic BCs), re-linearise the Hamiltonian constraint around the current
psi (aCoef/rhs from SetLevelData formulas), solve the linear system with
MG-preconditioned BiCGStab, then update psi += dpsi and check the composite
norm of dpsi for convergence/divergence.

The whole per-iteration computation (K integral, coefficients, linear solve,
update, norm) is ONE jit-compiled function: shapes repeat across iterations,
so it compiles once and re-runs cheaply — the analogue of the
reference's re-defined operator factories per iteration.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import jax
import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig
from mg_ic_code_tpu.grid.geometry import HierarchyGeom
from mg_ic_code_tpu.ops.ghosts import fill_ghosts
from mg_ic_code_tpu.physics import level_data as ld
from mg_ic_code_tpu.io.logging import pout
from mg_ic_code_tpu.solver import composite as comp
from mg_ic_code_tpu.solver import reductions as red

DIVERGENCE_NORM = 1.0e5  # early-exit threshold (Main_PoissonSolver.cpp:212)
FAILURE_NORM = 1.0e-1  # MayDay threshold (Main_PoissonSolver.cpp:222)


class NonConvergenceError(RuntimeError):
    """Raised when the NL loop ends with ||dpsi|| > 0.1, mirroring the
    reference's MayDay::Error('NL iterations did not converge...')."""


@dataclasses.dataclass
class NLResult:
    psi: list  # regular part of the conformal factor, per level
    dpsi: list
    constant_K: float
    dpsi_norm_history: list[float]
    linear_iters: list[int]
    linear_residuals: list[float]
    converged: bool
    geom: HierarchyGeom = None
    fields: list = None
    # wall seconds of each Picard iteration, device work included (the
    # first one carries the compile)
    iter_seconds: list = None


def ghosted_psi(geom: HierarchyGeom, psi_list, level: int):
    """psi with ghosts: CF-quadratic from the coarser level, physical
    Dirichlet at value 1 + bc_value (psi -> 1 + dpsi_face asymptotically:
    the initial guess is psi=1 and every dpsi carries face value bc_value),
    Neumann/periodic as configured."""
    return fill_ghosts(
        psi_list[level], geom, level,
        coarse_u=psi_list[geom.parent[level]] if level > 0 else None,
        homogeneous_phys=False,
        dirichlet_shift=1.0,
    )


def compute_constant_k(geom: HierarchyGeom, cfg: SolverConfig, fields, psi_list):
    """Integrability condition for periodic BCs: K = -sqrt(|integral|/V)
    with the integrand of SetLevelData.cpp:131-187
    (Main_PoissonSolver.cpp:137-150)."""
    integrand = [
        ld.constant_k_integrand(
            ghosted_psi(geom, psi_list, l), fields[l], cfg, geom.dx[l]
        )
        for l in range(geom.num_levels)
    ]
    integral = red.composite_sum(integrand, geom)
    volume = math.prod(geom.domain_length)
    return -jnp.sqrt(jnp.abs(integral) / volume)


def prepare_iteration(
    geom: HierarchyGeom, cfg: SolverConfig, fields, psi_list
):
    """Coefficient/rhs setup for one Picard iteration (the set_a_coef /
    set_b_coef / set_rhs + constant-K block of the driver loop,
    Main_PoissonSolver.cpp:137-160). Small graph; compiles per config."""
    constant_K = (
        compute_constant_k(geom, cfg, fields, psi_list)
        if cfg.is_periodic
        else jnp.asarray(0.0, psi_list[0].dtype)
    )
    a_list, rhs_list = [], []
    for l in range(geom.num_levels):
        psi_gh = ghosted_psi(geom, psi_list, l)
        a_list.append(ld.set_a_coef(psi_list[l], fields[l], cfg, constant_K))
        rhs_list.append(
            ld.set_rhs(psi_gh, fields[l], cfg, geom.dx[l], constant_K)
        )
    return a_list, rhs_list, constant_K


def finish_iteration(
    geom: HierarchyGeom, psi_list, dpsi_list, average_down: bool = False
):
    """psi += dpsi (set_update_psi0) and the composite L2 norm of dpsi
    (computeNorm, Main_PoissonSolver.cpp:208). With `average_down`, covered
    coarse cells are then replaced by the restriction of the finer level
    (framework extension: keeps the coarse linearisation consistent with
    the fine solution and lowers the Picard plateau)."""
    from mg_ic_code_tpu.ops import stencils as st

    psi = [p + d for p, d in zip(psi_list, dpsi_list)]
    if average_down:
        # children before parents (entries are parent-ordered)
        for c in range(geom.num_levels - 1, 0, -1):
            p = geom.parent[c]
            psi[p] = psi[p].at[geom.child_slices(p, c)].set(
                st.restrict_full(psi[c])
            )
    return psi, red.composite_norm(dpsi_list, geom, p=2)


prepare_iteration_jit = jax.jit(prepare_iteration, static_argnums=(0, 1))
finish_iteration_jit = jax.jit(finish_iteration, static_argnums=(0, 3))


def _fused_iteration(spec, cfg: SolverConfig, fields, psi_list, dpsi_list):
    """prepare + build_coefs + solve + finish as ONE traced program.

    Production runs one fixed (spec, cfg), where splitting the iteration
    into four jitted stages only buys executable reuse nobody exercises —
    and costs a fixed per-dispatch tax per stage (the whole-iteration
    analogue of the reference running its entire driver loop per process,
    Main_PoissonSolver.cpp:137-225). Fusing the stages removes three of
    the four host dispatches per Picard iteration and lets XLA overlap
    the coefficient build with the solve's first ghost fills."""
    geom = spec.geom
    a_list, rhs_list, constant_K = prepare_iteration(
        geom, cfg, fields, psi_list
    )
    coefs = comp.build_coefs(spec, a_list)
    out = comp.solve_linear(spec, coefs, rhs_list, dpsi_list)
    psi, dpsi_norm = finish_iteration(geom, psi_list, out.x,
                                      cfg.average_down)
    return psi, out.x, dpsi_norm, constant_K, {
        "iters": out.iters,
        "initial_rnorm": out.initial_rnorm,
        "final_rnorm": out.final_rnorm,
        "converged": out.converged,
    }


_fused_iteration_jit = jax.jit(_fused_iteration, static_argnums=(0, 1))


def nl_iteration(
    spec: comp.AMRSolverSpec, cfg: SolverConfig, fields, psi_list, dpsi_list,
    jitted: bool = True,
):
    """One Picard iteration. Returns (psi, dpsi, dpsi_norm, K, stats).

    `jitted` runs the whole iteration as ONE executable
    (`_fused_iteration_jit`): one host dispatch per Picard step instead
    of four. `jitted=False` keeps the eager staged composition for
    debugging and for callers (the phase profiler) that need to time the
    prepare/build/solve/finish stages separately.
    """
    # dpsi carries over between NL iterations as the initial guess (the
    # reference allocates dpsi once and never re-zeroes it before solve())
    if jitted:
        return _fused_iteration_jit(spec, cfg, fields, psi_list, dpsi_list)
    return _fused_iteration(spec, cfg, fields, psi_list, dpsi_list)


def poisson_solve(
    cfg: SolverConfig,
    geom: HierarchyGeom | None = None,
    dtype=jnp.float64,
    verbose: bool | None = None,
    output_hook=None,
    initial_psi=None,
    mesh=None,
) -> NLResult:
    """Full nonlinear solve (the reference's poissonSolve,
    Main_PoissonSolver.cpp:45-256). `output_hook(iter, state)` is called
    before each linear solve — the slot where the reference writes its
    per-iteration HDF5 snapshot (output_solver_data). `initial_psi`
    warm-starts from a previous solution (e.g. io.restart.load_state).
    `mesh` (jax.sharding.Mesh) runs the distributed solve: level arrays are
    sharded per parallel.mesh policy and the hot smoother takes the
    explicit ppermute-halo shard_map path."""
    if geom is None:
        from mg_ic_code_tpu.grid.tagging import generate_hierarchy

        geom = generate_hierarchy(cfg)
    if verbose is None:
        verbose = cfg.verbosity >= 2

    fields = [
        ld.problem_fields_jit(geom, cfg, l, dtype)
        for l in range(geom.num_levels)
    ]
    state = ld.initial_state(geom, cfg, dtype)
    psi, dpsi = state["psi"], state["dpsi"]
    if initial_psi is not None:
        psi = [jnp.asarray(p, dtype) for p in initial_psi]
    if mesh is not None:
        from mg_ic_code_tpu.parallel import mesh as pmesh

        psi = pmesh.shard_level_list(psi, geom, mesh)
        dpsi = pmesh.shard_level_list(dpsi, geom, mesh)
        fields = pmesh.shard_fields(fields, geom, mesh)

    history: list[float] = []
    lin_iters: list[int] = []
    lin_resid: list[float] = []
    iter_seconds: list[float] = []
    constant_K = 0.0
    spec = comp.make_amr_spec(geom, cfg, mesh)

    from mg_ic_code_tpu.utils import profiling

    dpsi_norm = 0.0
    for nl_iter in range(cfg.max_nl_iterations):
        if verbose:
            pout(
                f"Main Loop Iteration {nl_iter + 1} out of "
                f"{cfg.max_nl_iterations}"
            )
        if output_hook is not None:
            with profiling.scope("output_solver_data"):
                output_hook(nl_iter, dict(psi=psi, dpsi=dpsi, geom=geom,
                                          fields=fields,
                                          constant_K=constant_K))

        t_iter = time.perf_counter()
        with profiling.scope("nl_iteration", block=True):
            psi, dpsi, dpsi_norm_dev, k_dev, stats = nl_iteration(
                spec, cfg, fields, psi, dpsi
            )
        dpsi_norm = float(dpsi_norm_dev)
        iter_seconds.append(time.perf_counter() - t_iter)
        constant_K = float(k_dev)
        history.append(dpsi_norm)
        lin_iters.append(int(stats["iters"]))
        lin_resid.append(float(stats["final_rnorm"]))
        if verbose:
            if cfg.is_periodic:
                pout(f"Constant average K value set to {constant_K}")
            pout(
                f"The norm of dpsi after step {nl_iter + 1} is {dpsi_norm}"
                f"  (linear: {int(stats['iters'])} iters, "
                f"residual {float(stats['final_rnorm']):.3e}, "
                f"{iter_seconds[-1]:.6f} s)"
            )
        if (
            dpsi_norm < cfg.tolerance
            or dpsi_norm > DIVERGENCE_NORM
            or math.isnan(dpsi_norm)
        ):
            break

    if verbose:
        pout(f"The norm of dpsi at the final step was {dpsi_norm}")
    if cfg.verbosity >= 3:  # hierarchical time report (CH_TIMER role)
        pout(profiling.report())
    if dpsi_norm > FAILURE_NORM or math.isnan(dpsi_norm):
        raise NonConvergenceError(
            "NL iterations did not converge - may need a better initial guess"
        )

    return NLResult(
        psi=psi,
        dpsi=dpsi,
        constant_K=constant_K,
        dpsi_norm_history=history,
        linear_iters=lin_iters,
        linear_residuals=lin_resid,
        converged=dpsi_norm < cfg.tolerance,
        geom=geom,
        fields=fields,
        iter_seconds=iter_seconds,
    )
