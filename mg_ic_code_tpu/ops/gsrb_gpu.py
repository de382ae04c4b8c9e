"""Fused red+black GSRB sweep for NVIDIA GPUs (Pallas, Triton route).

The XLA smoother (multigrid.relax's fori_loop body) makes one pass through
device memory per colour: it reads u, rhs, aCoef and lambda, and writes u,
twice per sweep. This kernel performs BOTH colours of a sweep in one launch,
so a sweep reads the four streams and writes u once.

Each program owns one (by, bz) tile of one x plane and computes, for every
cell c of the tile, the first colour's result at c and at its six
neighbours (recomputed from the old u, so no program waits on another),
then the second colour's update at c from those. The recompute reads u on
the radius-2 stencil ball and rhs/aCoef/lambda on the 7-point stencil;
neighbouring programs read the same lines, so the repeats are meant to hit
L1/L2 rather than device memory (PERF.md has the measured share of the
bytes bound).

Semantics are exactly multigrid.relax's XLA body on a constant-bCoef level:
homogeneous ghosts rebuilt before each colour by the one shared rule
(ghosts.ghost_plane: Dirichlet quadratic, Neumann, coarse-fine with rho),
periodic wrap, and the global checkerboard parity offset by the box's `lo`.
Index arithmetic clamps (or wraps, on periodic axes) every load into the
array, so lanes past a non-power-of-two edge read valid memory and are
masked only at the store.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from mg_ic_code_tpu.ops.ghosts import PERIODIC, ghost_plane

# (by, bz) tile of a y-z plane (powers of two, as Triton requires), run at
# two cells per thread (by*bz/64 warps): the recompute keeps ~50 loaded
# values live per cell. The tiles measured on one H100 are in PERF.md;
# the flagship's y/z extents are multiples of 16
TILE = (16, 16)


def _unit(ax: int, k: int) -> tuple[int, int, int]:
    s = [0, 0, 0]
    s[ax] = k
    return tuple(s)


def _add(s, t):
    return tuple(a + b for a, b in zip(s, t))


def _sweep_kernel(u_ref, rhs_ref, a_ref, lam_ref, o_ref, *, shape, kinds,
                  rho, alpha, beta, dx, lo_sum, by, bz):
    n = shape
    periodic = tuple(kinds[ax][0] == PERIODIC for ax in range(3))
    inv_dx2 = 1.0 / (dx * dx)
    x = pl.program_id(2)
    y = pl.program_id(1) * by + jnp.arange(by, dtype=jnp.int32)[:, None]
    z = pl.program_id(0) * bz + jnp.arange(bz, dtype=jnp.int32)[None, :]
    pos = (x, y, z)

    def coord(ax, s):
        """Index along `ax` of the cell at offset s, wrapped on a periodic
        axis (|s| <= 2 < n there)."""
        q = pos[ax] + s
        if periodic[ax] and s != 0:
            q = jnp.where(q < 0, q + n[ax], jnp.where(q >= n[ax], q - n[ax], q))
        return q

    loads: dict = {}

    def raw(ref, name, s):
        """`ref` at offset s from every cell of the tile, clamped into the
        array (clamped lanes are never used unmasked)."""
        key = (name, s)
        if key not in loads:
            idx = [
                jnp.broadcast_to(jnp.clip(coord(ax, s[ax]), 0, n[ax] - 1),
                                 (by, bz))
                for ax in range(3)
            ]
            loads[key] = plgpu.load(ref.at[idx[0], idx[1], idx[2]])
        return loads[key]

    def outside(ax, s):
        q = pos[ax] + s
        return q < 0 if s < 0 else q >= n[ax]

    def with_ghosts(value_at, s, inward):
        """value_at(s) where the cell at offset s lies in the domain, and
        the homogeneous ghost rule of `value_at` where it lies one cell
        outside a non-periodic face."""
        v = value_at(s)
        for ax in range(3):
            if periodic[ax] or s[ax] == 0:
                continue
            side = 0 if s[ax] < 0 else 1
            g = ghost_plane(kinds[ax][side], *inward(ax, s, side), rho)
            v = jnp.where(outside(ax, s[ax]), g, v)
        return v

    def u_gh(s):
        def inward(ax, s, side):
            e = _unit(ax, 1 if side == 0 else -1)
            return (raw(u_ref, "u", _add(s, e)),
                    raw(u_ref, "u", _add(_add(s, e), e)))

        return with_ghosts(lambda t: raw(u_ref, "u", t), s, inward)

    def parity(s):
        return jnp.bitwise_and(
            coord(0, s[0]) + coord(1, s[1]) + coord(2, s[2]) + lo_sum, 1
        )

    def update(c, nb, s):
        lap = (nb - 6.0 * c) * inv_dx2
        lofu = alpha * raw(a_ref, "a", s) * c - beta * lap
        return c - raw(lam_ref, "lam", s) * (lofu - raw(rhs_ref, "rhs", s))

    def neighbour_sum(value_at, s):
        tot = None
        for ax in range(3):
            for k in (1, -1):
                v = value_at(_add(s, _unit(ax, k)))
                tot = v if tot is None else tot + v
        return tot

    reds: dict = {}

    def red(s):
        """u after the first colour pass, at offset s (an in-domain or
        periodically wrapped cell)."""
        if s not in reds:
            c = raw(u_ref, "u", s)
            upd = update(c, neighbour_sum(u_gh, s), s)
            reds[s] = jnp.where(parity(s) == 0, upd, c)
        return reds[s]

    def red_gh(s):
        def inward(ax, s, side):
            # the ghost at c -/+ e is built from the face cell (c itself)
            # and the next cell inward (c +/- e = offset -s)
            return red((0, 0, 0)), red(tuple(-v for v in s))

        return with_ghosts(red, s, inward)

    zero = (0, 0, 0)
    c = red(zero)
    out = jnp.where(parity(zero) == 1, update(c, neighbour_sum(red_gh, zero),
                                              zero), c)
    ok = (y < n[1]) & (z < n[2])
    plgpu.store(o_ref.at[jnp.broadcast_to(x, (by, bz)),
                         jnp.broadcast_to(y, (by, bz)),
                         jnp.broadcast_to(z, (by, bz))],
                out.astype(o_ref.dtype), mask=ok)


@functools.partial(
    jax.jit,
    static_argnames=("kinds", "rho", "alpha", "beta", "dx", "lo", "nsweeps",
                     "interpret", "tile"),
)
def gsrb_relax(u, rhs, a, lam, *, kinds, rho, alpha, beta, dx, lo,
               nsweeps: int, interpret: bool = False, tile=TILE):
    """`nsweeps` red+black GSRB sweeps with homogeneous ghosts on a
    constant-bCoef level, one fused launch per sweep. Equal, up to
    floating-point reassociation, to multigrid.relax's XLA body with the
    same (kinds, rho, alpha, beta, dx, lo)."""
    shape = u.shape
    by, bz = tile
    grid = (pl.cdiv(shape[2], bz), pl.cdiv(shape[1], by), shape[0])
    kernel = functools.partial(
        _sweep_kernel, shape=shape, kinds=kinds, rho=rho, alpha=alpha,
        beta=beta, dx=dx, lo_sum=sum(lo), by=by, bz=bz,
    )
    sweep = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(shape, u.dtype),
        grid=grid,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, by * bz // 64), num_stages=1),
        interpret=interpret,
        name="gsrb_sweep",
    )
    return jax.lax.fori_loop(
        0, nsweeps, lambda _, uu: sweep(uu, rhs, a, lam), u
    )
