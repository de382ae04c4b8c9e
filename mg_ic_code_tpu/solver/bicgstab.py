"""Preconditioned BiCGStab over arbitrary pytrees of level arrays.

JAX equivalent of Chombo's BiCGStabSolver<Vector<LevelData>> as used
by the reference driver (Main_PoissonSolver.cpp:104,174-184): max-norm
(m_normType = 0) convergence relative to the initial residual, iteration cap
m_imax, small-residual hang guard. Implemented as a jit-compatible
`lax.while_loop` on a pytree state so the whole Krylov solve is one XLA
computation — dot products become fused on-device reductions (the analogue of
Chombo's MPI_Allreduce dot products).

The operator applies with homogeneous physical BCs (Krylov directions carry
no boundary inhomogeneity); the caller folds inhomogeneous BCs into the
initial residual, as Chombo's solve() does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class BiCGStabResult(NamedTuple):
    x: object  # solution pytree
    iters: jax.Array
    final_rnorm: jax.Array
    initial_rnorm: jax.Array
    converged: jax.Array
    breakdown: jax.Array
    hung: jax.Array = False


def _axpy(a, x, y):
    return jax.tree.map(lambda xi, yi: a * xi + yi, x, y)


def _scale(a, x):
    return jax.tree.map(lambda xi: a * xi, x)


def _add(x, y):
    return jax.tree.map(jnp.add, x, y)


def _sub(x, y):
    return jax.tree.map(jnp.subtract, x, y)


def _zeros_like(x):
    return jax.tree.map(jnp.zeros_like, x)


def bicgstab(
    apply_fn: Callable,
    rhs,
    x0=None,
    precond_fn: Callable | None = None,
    dot_fn: Callable | None = None,
    norm_fn: Callable | None = None,
    tol: float = 1.0e-10,
    max_iter: int = 100,
    hang: float = 0.0,
) -> BiCGStabResult:
    """Solve A x = rhs with (optionally preconditioned) BiCGStab.

    apply_fn(x): the homogeneous linear operator. precond_fn(r) ~ A^-1 r
    (default identity). dot_fn: inner product (default unweighted sum).
    norm_fn: convergence norm (default max-norm, matching the reference's
    solver.m_normType = 0). Stops when ||r|| <= tol * ||r0|| (or on
    breakdown of the recurrence, reported via `breakdown`).
    """
    if precond_fn is None:
        precond_fn = lambda r: r
    if dot_fn is None:
        dot_fn = lambda u, v: sum(
            jnp.sum(ul * vl) for ul, vl in zip(jax.tree.leaves(u), jax.tree.leaves(v))
        )
    if norm_fn is None:
        norm_fn = lambda u: jnp.max(
            jnp.asarray([jnp.max(jnp.abs(l)) for l in jax.tree.leaves(u)])
        )

    if x0 is None:
        x = _zeros_like(rhs)
        r = rhs
    else:
        x = x0
        r = _sub(rhs, apply_fn(x0))

    r0norm = norm_fn(r)
    eps_abs = jnp.asarray(1e-300, r0norm.dtype)

    one = jnp.ones((), r0norm.dtype)

    state = dict(
        x=x, r=r, rhat=r, p=_zeros_like(r), v=_zeros_like(r),
        rho=one, alpha=one, omega=one,
        it=jnp.zeros((), jnp.int32),
        rnorm=r0norm,
        best=r0norm,
        stall=jnp.zeros((), jnp.int32),
        restarts=jnp.zeros((), jnp.int32),
        breakdown=jnp.zeros((), jnp.bool_),
        hung=jnp.zeros((), jnp.bool_),
    )

    MAX_RESTARTS = 4
    STALL_ITERS = 4

    def cond(s):
        not_done = s["rnorm"] > jnp.maximum(tol * r0norm, eps_abs)
        return (
            (s["it"] < max_iter) & not_done & (~s["breakdown"]) & (~s["hung"])
        )

    def body(s):
        rho_new = dot_fn(s["rhat"], s["r"])
        rho_om = s["rho"] * s["omega"]
        beta = jnp.where(
            rho_om == 0.0, 0.0,
            (rho_new / jnp.where(rho_om == 0.0, 1.0, rho_om)) * s["alpha"],
        )
        bd = (rho_new == 0.0) | (s["omega"] == 0.0)

        p = _axpy(beta, _axpy(-s["omega"], s["v"], s["p"]), s["r"])
        phat = precond_fn(p)
        v = apply_fn(phat)
        rv = dot_fn(s["rhat"], v)
        bd = bd | (rv == 0.0)
        # on breakdown the step factors become 0 so the final (exiting)
        # iteration is a NO-OP on x — a 1.0-denominator placeholder would
        # apply a garbage-scaled update that bottom_solve then consumes
        alpha = jnp.where(rv == 0.0, 0.0, rho_new / jnp.where(rv == 0.0, 1.0, rv))
        srch = _axpy(-alpha, v, s["r"])  # s
        shat = precond_fn(srch)
        t = apply_fn(shat)
        tt = dot_fn(t, t)
        omega = dot_fn(t, srch) / jnp.where(tt == 0.0, 1.0, tt)

        x = _add(s["x"], _add(_scale(alpha, phat), _scale(omega, shat)))
        r = _axpy(-omega, t, srch)
        rnorm = norm_fn(r)

        new = dict(
            x=x, r=r, rhat=s["rhat"], p=p, v=v,
            rho=rho_new, alpha=alpha, omega=omega,
            it=s["it"] + 1,
            rnorm=rnorm,
            best=jnp.minimum(s["best"], rnorm),
            stall=s["stall"], restarts=s["restarts"],
            breakdown=bd, hung=s["hung"],
        )

        if hang > 0.0:
            # Chombo-style hang handling (m_hang, BiCGStabSolver): BiCGStab
            # residual norms are not monotone, so stalling is measured
            # against the BEST norm so far: an iteration that fails to push
            # the best norm down by the factor (1-hang) counts as a stall;
            # after STALL_ITERS consecutive stalls, RESTART the recurrence
            # from the true residual. After MAX_RESTARTS restarts, declare
            # the solve hung.
            improving = rnorm <= (1.0 - hang) * s["best"]
            stall = jnp.where(improving, 0, s["stall"] + 1)
            do_restart = (stall >= STALL_ITERS) & (
                s["restarts"] < MAX_RESTARTS
            )
            hung = s["hung"] | (
                (stall >= STALL_ITERS) & (s["restarts"] >= MAX_RESTARTS)
            )

            def restarted(st):
                r_true = _sub(rhs, apply_fn(st["x"]))
                st = dict(st)
                rn = norm_fn(r_true)
                st.update(
                    r=r_true, rhat=r_true,
                    p=_zeros_like(r_true), v=_zeros_like(r_true),
                    rho=one, alpha=one, omega=one,
                    rnorm=rn,
                    best=jnp.minimum(st["best"], rn),
                    stall=jnp.zeros((), jnp.int32),
                    restarts=st["restarts"] + 1,
                )
                return st

            new.update(stall=stall, hung=hung)
            new = jax.lax.cond(do_restart, restarted, lambda st: st, new)
        return new

    out = jax.lax.while_loop(cond, body, state)
    return BiCGStabResult(
        x=out["x"],
        iters=out["it"],
        final_rnorm=out["rnorm"],
        initial_rnorm=r0norm,
        converged=out["rnorm"] <= jnp.maximum(tol * r0norm, eps_abs),
        breakdown=out["breakdown"],
        hung=out["hung"],
    )
