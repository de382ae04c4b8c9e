"""Core stencil kernels as fused XLA element-wise graphs (pure JAX).

JAX re-design of the reference's ChF Fortran kernels
(VariableCoeffPoissonOperatorF.ChF): GSRBHELMHOLTZVC3D, VCCOMPUTEOP3D,
VCCOMPUTERES3D, RESTRICTRESVC3D, plus AMRPoissonOp's piecewise-constant
prolongIncrement and CoarseAverage's arithmetic/harmonic coefficient
coarsening (VariableCoeffPoissonOperatorFactory.cpp:205-223).

Convention: `u_gh` denotes an array carrying ONE ghost ring (shape n+2 per
axis) whose ghosts have already been filled (physical BC / coarse-fine /
periodic wrap); all other fields are ghost-free interior arrays of shape n.
All functions are shape-polymorphic and dtype-generic, and are designed to
fuse into a handful of HBM-bandwidth-bound XLA loops. A fused GPU kernel
for the smoother lives in ops/gsrb_gpu.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_I = slice(1, -1)  # interior of a ghosted array


def laplacian(u_gh: jax.Array, dx) -> jax.Array:
    """7-point Laplacian (2nd order), ChF GETLAPLACIANPSIF / the `ldpsi`
    term of VCCOMPUTEOP3D (VariableCoeffPoissonOperatorF.ChF:216-227)."""
    c = u_gh[_I, _I, _I]
    s = (
        u_gh[2:, _I, _I]
        + u_gh[:-2, _I, _I]
        + u_gh[_I, 2:, _I]
        + u_gh[_I, :-2, _I]
        + u_gh[_I, _I, 2:]
        + u_gh[_I, _I, :-2]
    )
    return (s - 6.0 * c) * (1.0 / (dx * dx))


def apply_op(u_gh, a_coef, b_coef, alpha, beta, dx):
    """L(u) = alpha*aCoef*u - beta*bCoef*Laplacian(u)  (VCCOMPUTEOP3D,
    VariableCoeffPoissonOperatorF.ChF:210-229). `b_coef=None` means the
    constant-1 bCoef of the reference physics (SetLevelData.cpp:330-340) and
    skips a full HBM read of bCoef."""
    lap = laplacian(u_gh, dx)
    if b_coef is not None:
        lap = lap * b_coef
    return alpha * a_coef * u_gh[_I, _I, _I] - beta * lap


def residual(u_gh, rhs, a_coef, b_coef, alpha, beta, dx):
    """res = rhs - L(u)  (VCCOMPUTERES3D, VariableCoeffPoissonOperatorF.ChF:
    313-333)."""
    return rhs - apply_op(u_gh, a_coef, b_coef, alpha, beta, dx)


def gsrb_lambda(a_coef, alpha, beta, dx):
    """Relaxation coefficient lambda = 1/(alpha*aCoef + 2*D*beta/dx^2):
    inverse diagonal of L under the bCoef≈1 assumption (reference:
    VariableCoeffPoissonOperator.cpp:220-249 resetLambda)."""
    return 1.0 / (alpha * a_coef + 6.0 * beta / (dx * dx))


def color_mask(shape, lo, red_black: int, dtype=jnp.bool_) -> jax.Array:
    """Checkerboard mask of cells with (i+j+k) ≡ red_black (mod 2), where
    i,j,k are GLOBAL level indices (the reference's parity is global because
    Chombo box indices are global: VariableCoeffPoissonOperatorF.ChF:99-106).
    """
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    par = (i + j + k + sum(lo) + red_black) % 2
    return (par == 0).astype(dtype) if dtype != jnp.bool_ else (par == 0)


def gsrb_color(u_gh, rhs, a_coef, b_coef, lam, alpha, beta, dx, lo,
               red_black: int):
    """One colour of a red-black Gauss-Seidel sweep (GSRBHELMHOLTZVC3D,
    VariableCoeffPoissonOperatorF.ChF:56-128): on cells of the given colour,
      u <- u - lambda * (L(u) - rhs).
    Returns the updated INTERIOR (ghost-free) array. Ghosts must be refreshed
    by the caller before the other colour runs (the reference re-exchanges
    and re-applies BCs between colours: VariableCoeffPoissonOperator.cpp:
    290-330)."""
    lofu = apply_op(u_gh, a_coef, b_coef, alpha, beta, dx)
    u = u_gh[_I, _I, _I]
    upd = u - lam * (lofu - rhs)
    mask = color_mask(u.shape, lo, red_black)
    return jnp.where(mask, upd, u)


def restrict_full(f: jax.Array) -> jax.Array:
    """Full-weighting 2x coarsening: average of the 2^3 children
    (the `/denom` accumulation of RESTRICTRESVC3D,
    VariableCoeffPoissonOperatorF.ChF:401-432).

    Implemented as a 2x2x2 stride-2 reduce_window, XLA's pooling
    primitive."""
    s = jax.lax.reduce_window(
        f, jnp.zeros((), f.dtype), jax.lax.add, (2, 2, 2), (2, 2, 2),
        "VALID",
    )
    return s * 0.125


def restrict_residual(u_gh, rhs, a_coef, b_coef, alpha, beta, dx):
    """Fused residual + full-weighting restriction: res[2h] = I(rhs - L(u))
    (RESTRICTRESVC3D, VariableCoeffPoissonOperatorF.ChF:379-432)."""
    return restrict_full(residual(u_gh, rhs, a_coef, b_coef, alpha, beta, dx))


def prolong_inc(u_fine: jax.Array, e_coarse: jax.Array) -> jax.Array:
    """Piecewise-constant prolongation increment: u_f[i] += e_c[i//2]
    (inherited AMRPoissonOp::prolongIncrement, see SURVEY §2b)."""
    e = jnp.repeat(jnp.repeat(jnp.repeat(e_coarse, 2, 0), 2, 1), 2, 2)
    return u_fine + e


def coarsen_coef(c: jax.Array, average_type: str) -> jax.Array:
    """Coefficient coarsening, arithmetic or harmonic 2^3-cell average
    (CoarseAverage::averageToCoarse / averageToCoarseHarmonic used by the MG
    operator factory, VariableCoeffPoissonOperatorFactory.cpp:205-223)."""
    if average_type == "arithmetic":
        return restrict_full(c)
    if average_type == "harmonic":
        return 1.0 / restrict_full(1.0 / c)
    raise ValueError(f"bad coefficient_average_type: {average_type}")


def face_flux(u_gh: jax.Array, axis: int, dx, b_face=None) -> jax.Array:
    """Face-centred flux F = b * du/dx_axis on the faces of the interior
    cells (one more entry than cells along `axis`). The working version of
    the reference's stubbed getFlux (VariableCoeffPoissonOperator.cpp:
    389-397; Chombo AMRPoissonOp semantics), used for flux-register style
    diagnostics."""
    nd = u_gh.ndim
    hi = tuple(
        slice(1, None) if d == axis else slice(1, -1) for d in range(nd)
    )
    lo = tuple(
        slice(0, -1) if d == axis else slice(1, -1) for d in range(nd)
    )
    grad = (u_gh[hi] - u_gh[lo]) * (1.0 / dx)
    if b_face is not None:
        grad = grad * b_face
    return grad


def laplacian6(u_gh3: jax.Array, dx) -> jax.Array:
    """6th-order Laplacian (the commented-out high-order variant at
    SetLevelDataF.ChF:41-50); needs THREE ghost layers on u."""
    c = (2.0, -27.0, 270.0, -490.0, 270.0, -27.0, 2.0)
    inv = 1.0 / (180.0 * dx * dx)
    n = u_gh3.shape
    out = 0.0
    for axis in range(3):
        for off, w in zip(range(-3, 4), c):
            sl = tuple(
                slice(3 + off, n[d] - 3 + off) if d == axis
                else slice(3, n[d] - 3)
                for d in range(3)
            )
            out = out + w * u_gh3[sl]
    return out * inv


def sum_faces(lhs: jax.Array, face_vals: jax.Array, axis: int, beta, scale):
    """Increment cell-centred data with the sum of the two adjacent
    face-centred values along `axis`, scaled: the ChF SUMFACES utility
    (VariableCoeffPoissonOperatorF.ChF:450-477). `face_vals` has one more
    entry than `lhs` along `axis`."""
    nd = lhs.ndim
    lo = tuple(
        slice(0, -1) if d == axis else slice(None) for d in range(nd)
    )
    hi = tuple(
        slice(1, None) if d == axis else slice(None) for d in range(nd)
    )
    return lhs + scale * beta * (face_vals[lo] + face_vals[hi])


def grad_energy(phi_gh: jax.Array, dx) -> jax.Array:
    """rho_grad = 1/2 * sum_d (d_d phi)^2 with 2nd-order central differences
    (GETRHOGRADPHIF, SetLevelDataF.ChF:65-103)."""
    inv2dx = 0.5 / dx
    gx = (phi_gh[2:, _I, _I] - phi_gh[:-2, _I, _I]) * inv2dx
    gy = (phi_gh[_I, 2:, _I] - phi_gh[_I, :-2, _I]) * inv2dx
    gz = (phi_gh[_I, _I, 2:] - phi_gh[_I, _I, :-2]) * inv2dx
    return 0.5 * (gx * gx + gy * gy + gz * gz)
