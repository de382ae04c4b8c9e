"""Plain NumPy scalar-loop oracles for the stencil kernels.

Independent re-statements of the operator math (written from the equations,
used only by tests): L(u) = alpha*a*u - beta*b*Lap(u) with the 7-point
Laplacian; GSRB update u -= lambda*(L(u)-rhs) on cells of one parity;
full-weighting restriction; piecewise-constant prolongation.
"""

import numpy as np


def laplacian_loops(u_gh, dx):
    n = tuple(s - 2 for s in u_gh.shape)
    out = np.zeros(n, dtype=u_gh.dtype)
    for i in range(n[0]):
        for j in range(n[1]):
            for k in range(n[2]):
                I, J, K = i + 1, j + 1, k + 1
                out[i, j, k] = (
                    u_gh[I + 1, J, K]
                    + u_gh[I - 1, J, K]
                    + u_gh[I, J + 1, K]
                    + u_gh[I, J - 1, K]
                    + u_gh[I, J, K + 1]
                    + u_gh[I, J, K - 1]
                    - 6.0 * u_gh[I, J, K]
                ) / (dx * dx)
    return out


def apply_op_loops(u_gh, a, b, alpha, beta, dx):
    lap = laplacian_loops(u_gh, dx)
    u = u_gh[1:-1, 1:-1, 1:-1]
    bb = 1.0 if b is None else b
    return alpha * a * u - beta * bb * lap


def gsrb_color_loops(u_gh, rhs, a, b, lam, alpha, beta, dx, lo, red_black):
    u_gh = u_gh.copy()
    n = rhs.shape
    for i in range(n[0]):
        for j in range(n[1]):
            for k in range(n[2]):
                gi = i + lo[0] + j + lo[1] + k + lo[2]
                if (gi + red_black) % 2 != 0:
                    continue
                I, J, K = i + 1, j + 1, k + 1
                bb = 1.0 if b is None else b[i, j, k]
                lap = (
                    u_gh[I + 1, J, K]
                    + u_gh[I - 1, J, K]
                    + u_gh[I, J + 1, K]
                    + u_gh[I, J - 1, K]
                    + u_gh[I, J, K + 1]
                    + u_gh[I, J, K - 1]
                    - 6.0 * u_gh[I, J, K]
                ) / (dx * dx)
                lofu = alpha * a[i, j, k] * u_gh[I, J, K] - beta * bb * lap
                u_gh[I, J, K] -= lam[i, j, k] * (lofu - rhs[i, j, k])
    return u_gh[1:-1, 1:-1, 1:-1]


def restrict_loops(f):
    n = tuple(s // 2 for s in f.shape)
    out = np.zeros(n, dtype=f.dtype)
    for i in range(n[0]):
        for j in range(n[1]):
            for k in range(n[2]):
                out[i, j, k] = f[
                    2 * i : 2 * i + 2, 2 * j : 2 * j + 2, 2 * k : 2 * k + 2
                ].mean()
    return out


def prolong_loops(e_c):
    n = tuple(2 * s for s in e_c.shape)
    out = np.zeros(n, dtype=e_c.dtype)
    for i in range(n[0]):
        for j in range(n[1]):
            for k in range(n[2]):
                out[i, j, k] = e_c[i // 2, j // 2, k // 2]
    return out


def ghost_fill_loops(u, kinds, rho):
    """One-ring homogeneous ghost fill from the face rules: Dirichlet
    (face value 0, quadratic) ghost = -2 u0 + u1/3; Neumann ghost = u0;
    coarse-fine (coarse term 0, quadratic through the coarse centre at
    -rho/2) ghost = 2(rho-1)/(1+rho) u0 + (1-rho)/(3+rho) u1; periodic
    ghost = the cell one period away. u0, u1 are the first and second
    cells inward from the face. Edge and corner ghosts stay 0 (the
    7-point stencil never reads them)."""
    n = u.shape
    g = np.zeros(tuple(s + 2 for s in n), dtype=u.dtype)
    g[1:-1, 1:-1, 1:-1] = u
    weights = {
        "dirichlet": (-2.0, 1.0 / 3.0),
        "neumann": (1.0, 0.0),
        "cf": (2.0 * (rho - 1.0) / (1.0 + rho), (1.0 - rho) / (3.0 + rho)),
    }
    for ax in range(3):
        for side in (0, 1):
            kind = kinds[ax][side]
            for i in range(n[(ax + 1) % 3]):
                for j in range(n[(ax + 2) % 3]):
                    def at(k):
                        idx = [0, 0, 0]
                        idx[ax] = k
                        idx[(ax + 1) % 3] = i
                        idx[(ax + 2) % 3] = j
                        return tuple(idx)

                    if kind == "periodic":
                        val = u[at(n[ax] - 1)] if side == 0 else u[at(0)]
                    else:
                        w0, w1 = weights[kind]
                        k0, k1 = (0, 1) if side == 0 else (n[ax] - 1, n[ax] - 2)
                        val = w0 * u[at(k0)] + w1 * u[at(k1)]
                    gi = [i + 1 if d == (ax + 1) % 3 else
                          j + 1 if d == (ax + 2) % 3 else
                          (0 if side == 0 else n[ax] + 1) for d in range(3)]
                    g[tuple(gi)] = val
    return g


def relax_loops(u, rhs, a, lam, alpha, beta, dx, lo, kinds, rho, nsweeps):
    """nsweeps red+black GSRB sweeps, ghosts refilled before each colour."""
    for _ in range(nsweeps):
        for color in (0, 1):
            u = gsrb_color_loops(ghost_fill_loops(u, kinds, rho), rhs, a,
                                 None, lam, alpha, beta, dx, lo, color)
    return u
