"""Explicit shard_map halo-exchange smoother for slab-sharded levels.

The JAX equivalent of the reference's per-smooth MPI ghost exchange
(`dpsi.exchange(m_exchangeCopier)` before every GSRB colour,
VariableCoeffPoissonOperator.cpp:301): each device owns an x-slab of the
dense level array; before each half-sweep the one-cell boundary planes ride
`ppermute` while y/z ghosts and physical/CF boundary rules are
applied locally. GSRB parity stays GLOBAL by offsetting the checkerboard
with the shard's global x origin.

This is the hand-scheduled path: the default jit/GSPMD path reaches the
same collectives automatically from sharded operands, but this one pins the
communication pattern (face-only, nearest-neighbour, overlappable) exactly
like the reference's trimmed-edge Copiers
(VariableCoeffPoissonOperatorFactory.cpp:83-96).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mg_ic_code_tpu.ops import stencils as st
from mg_ic_code_tpu.ops.ghosts import PERIODIC
from mg_ic_code_tpu.parallel.mesh import AXIS
from mg_ic_code_tpu.solver.multigrid import LevelMGSpec

_I = slice(1, -1)


def _bc_plane(kind: str, u0, u1, rho: float):
    """Homogeneous ghost plane from the two interior planes (the single
    shared rule — a formula fix must land in exactly one place)."""
    from mg_ic_code_tpu.ops.ghosts import ghost_plane

    return ghost_plane(kind, u0, u1, rho)


def _fill_local_yz(u_gh, kinds, rho: float, x_slice=_I):
    """Fill the y and z ghost faces (entirely shard-local). `x_slice`
    selects the x rows carrying real data (slice(1,-1) when the x axis is
    halo-padded, slice(None) when it is not)."""
    for axis in (1, 2):
        if kinds[axis][0] == PERIODIC:
            idx0 = [x_slice, _I, _I]
            idx1 = [x_slice, _I, _I]
            src0 = [x_slice, _I, _I]
            src1 = [x_slice, _I, _I]
            idx0[axis], src0[axis] = 0, u_gh.shape[axis] - 2
            idx1[axis], src1[axis] = u_gh.shape[axis] - 1, 1
            u_gh = u_gh.at[tuple(idx0)].set(u_gh[tuple(src0)])
            u_gh = u_gh.at[tuple(idx1)].set(u_gh[tuple(src1)])
            continue
        for side in (0, 1):
            kind = kinds[axis][side]
            i0 = [x_slice, _I, _I]
            i1 = [x_slice, _I, _I]
            tgt = [x_slice, _I, _I]
            if side == 0:
                tgt[axis], i0[axis], i1[axis] = 0, 1, 2
            else:
                m = u_gh.shape[axis]
                tgt[axis], i0[axis], i1[axis] = m - 1, m - 2, m - 3
            plane = _bc_plane(kind, u_gh[tuple(i0)], u_gh[tuple(i1)], rho)
            u_gh = u_gh.at[tuple(tgt)].set(plane)
    return u_gh


def _sharded_ghost(u_loc, kinds, rho: float, nshards: int, periodic_x: bool):
    """Assemble the local padded array: ppermute x-halos + local fills.
    The x exchange is the 1-D instance of the generic per-axis scheme
    (_axis_planes): ring ppermute of the boundary planes, with mesh-edge
    shards overwriting the wrapped plane by the physical/CF rule."""
    from_left, from_right = _axis_planes(
        u_loc, 0, kinds[0][0], kinds[0][1], rho, periodic_x, nshards, AXIS
    )
    u_ext = jnp.concatenate([from_left, u_loc, from_right], axis=0)
    u_gh = jnp.pad(u_ext, ((0, 0), (1, 1), (1, 1)))
    return _fill_local_yz(u_gh, kinds, rho)


def _pad_yz(block, kinds, rho: float):
    """Pad axes 1,2 by one and fill those faces with their ghost rules
    (no x padding; x neighbours are supplied separately)."""
    b = jnp.pad(block, ((0, 0), (1, 1), (1, 1)))
    return _fill_local_yz(b, kinds, rho, x_slice=slice(None))


def make_sharded_level_ops(
    spec: LevelMGSpec, mesh, d: int = 0, nsweeps: int | None = None,
    overlap: bool = True,
):
    """Build shard_map'ed relax / residual for depth `d` of a level.

    Returns (relax_fn(a, lam, u, rhs), residual_fn(a, u, rhs)), with every
    array argument sharded P('x', None, None); relax runs `nsweeps`
    (default spec.nsmooth) red+black sweeps.

    With `overlap=True` each half-sweep splits the update into an interior
    part (x rows 1..m-2, no halo dependency) and two boundary planes that
    consume the ppermute results — the data dependencies let XLA hide the
    halo latency under the interior compute, the same
    interior-first scheme the reference would need for its exchange overlap
    (SURVEY §5 long-context entry).
    """
    if nsweeps is None:
        nsweeps = spec.nsmooth
    nshards = mesh.shape[AXIS]
    kinds = spec.kinds
    periodic_x = kinds[0][0] == PERIODIC
    rho = spec.rho[d]
    dx = spec.dx[d]
    alpha, beta = spec.alpha, spec.beta
    inv_dx2 = 1.0 / (dx * dx)
    box = spec.boxes[d]
    nx_loc = box.shape[0] // nshards
    assert box.shape[0] % nshards == 0, "x extent must divide the mesh"
    overlap = overlap and nx_loc >= 3  # need a nonempty interior
    pspec = P(AXIS, None, None)

    def ghost(u_loc):
        return _sharded_ghost(u_loc, kinds, rho, nshards, periodic_x)

    def local_lo_sum(u_loc):
        idx = jax.lax.axis_index(AXIS)
        return sum(box.lo) + idx * nx_loc

    def exchange(u_loc):
        """Face-plane halo exchange (+ BC planes at mesh ends) — the 1-D
        instance of the generic per-axis scheme (_axis_planes)."""
        return _axis_planes(
            u_loc, 0, kinds[0][0], kinds[0][1], rho, periodic_x, nshards,
            AXIS,
        )

    def _masked_update(uc, x_lo, x_hi, a_s, lam_s, rhs_s, row0_gidx):
        """GSRB-style update of a row block given its x-neighbour planes;
        parity handled by the caller via row0_gidx offset + colour."""
        gh = _pad_yz(uc, kinds, rho)
        yz = (
            gh[:, 2:, 1:-1] + gh[:, :-2, 1:-1]
            + gh[:, 1:-1, 2:] + gh[:, 1:-1, :-2]
        )
        lap = (x_lo + x_hi + yz - 6.0 * uc) * inv_dx2
        lofu = alpha * a_s * uc - beta * lap
        return uc - lam_s * (lofu - rhs_s), row0_gidx

    def _parity_select(upd, uc, row0_gidx, color):
        ii = jax.lax.broadcasted_iota(jnp.int32, uc.shape, 0) + row0_gidx
        jj = jax.lax.broadcasted_iota(jnp.int32, uc.shape, 1)
        kk = jax.lax.broadcasted_iota(jnp.int32, uc.shape, 2)
        par = (ii + jj + kk + color) % 2
        return jnp.where(par == 0, upd, uc)

    def relax_body(a, lam, u, rhs):
        lo_sum = local_lo_sum(u)

        if not overlap:
            def half(i, uu):
                u_gh = ghost(uu)
                lofu = st.apply_op(u_gh, a, None, alpha, beta, dx)
                upd = uu - lam * (lofu - rhs)
                ii = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 0)
                jj = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 1)
                kk = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 2)
                par = (ii + jj + kk + lo_sum + i % 2) % 2
                return jnp.where(par == 0, upd, uu)

            return jax.lax.fori_loop(0, 2 * nsweeps, half, u)

        def half(i, uu):
            color = i % 2
            # 1. issue halo exchange for the boundary planes
            from_left, from_right = exchange(uu)
            # 2. interior rows 1..m-2: purely local -> overlaps the permute
            upd_int, _ = _masked_update(
                uu[1:-1], uu[:-2], uu[2:],
                a[1:-1], lam[1:-1], rhs[1:-1], lo_sum + 1,
            )
            out_int = _parity_select(upd_int, uu[1:-1], lo_sum + 1, color)
            # 3. boundary rows consume the halo planes
            upd_lo, _ = _masked_update(
                uu[:1], from_left, uu[1:2],
                a[:1], lam[:1], rhs[:1], lo_sum,
            )
            out_lo = _parity_select(upd_lo, uu[:1], lo_sum, color)
            upd_hi, _ = _masked_update(
                uu[-1:], uu[-2:-1], from_right,
                a[-1:], lam[-1:], rhs[-1:], lo_sum + nx_loc - 1,
            )
            out_hi = _parity_select(
                upd_hi, uu[-1:], lo_sum + nx_loc - 1, color
            )
            return jnp.concatenate([out_lo, out_int, out_hi], axis=0)

        return jax.lax.fori_loop(0, 2 * nsweeps, half, u)

    def residual_body(a, u, rhs):
        u_gh = ghost(u)
        return st.residual(u_gh, rhs, a, None, alpha, beta, dx)

    relax_fn = jax.shard_map(
        relax_body,
        mesh=mesh,
        in_specs=(pspec, pspec, pspec, pspec),
        out_specs=pspec,
    )
    residual_fn = jax.shard_map(
        residual_body,
        mesh=mesh,
        in_specs=(pspec, pspec, pspec),
        out_specs=pspec,
    )
    return relax_fn, residual_fn


# --------------------------------------------------------------------------
# 2-D (x, y) pencil decomposition: explicit ppermute halos on both axes
# --------------------------------------------------------------------------


def _ring_exchange_axis(arr, mesh_axis: str, nshards: int, axis: int):
    """Ring-ppermute the two boundary planes of `arr` along array `axis`
    over mesh axis `mesh_axis`. Returns (from_lo_neighbour, from_hi_
    neighbour) — each one plane thick along `axis`."""
    fwd = [(i, (i + 1) % nshards) for i in range(nshards)]
    bwd = [(i, (i - 1) % nshards) for i in range(nshards)]
    last = tuple(
        slice(-1, None) if d == axis else slice(None) for d in range(arr.ndim)
    )
    first = tuple(
        slice(0, 1) if d == axis else slice(None) for d in range(arr.ndim)
    )
    from_lo = jax.lax.ppermute(arr[last], mesh_axis, fwd)
    from_hi = jax.lax.ppermute(arr[first], mesh_axis, bwd)
    return from_lo, from_hi


def _axis_planes(arr, axis: int, kind_lo: str, kind_hi: str, rho: float,
                 periodic: bool, nshards: int, mesh_axis: str):
    """The two ghost planes of `arr` along `axis`: neighbour planes via
    ring ppermute when the axis is mesh-sharded (nshards > 1), else local
    wrap/BC rules; mesh-edge shards overwrite the wrapped plane with the
    physical/CF rule (exactly the 1-D x-slab scheme, per axis)."""
    n = arr.shape[axis]

    def pl(i0):
        sl = tuple(
            slice(i0, i0 + 1) if d == axis else slice(None)
            for d in range(arr.ndim)
        )
        return arr[sl]

    if nshards > 1:
        from_lo, from_hi = _ring_exchange_axis(arr, mesh_axis, nshards, axis)
        if not periodic:
            idx = jax.lax.axis_index(mesh_axis)
            lo_bc = _bc_plane(kind_lo, pl(0), pl(1), rho)
            hi_bc = _bc_plane(kind_hi, pl(n - 1), pl(n - 2), rho)
            from_lo = jnp.where(idx == 0, lo_bc, from_lo)
            from_hi = jnp.where(idx == nshards - 1, hi_bc, from_hi)
        return from_lo, from_hi
    if periodic:
        return pl(n - 1), pl(0)
    return (
        _bc_plane(kind_lo, pl(0), pl(1), rho),
        _bc_plane(kind_hi, pl(n - 1), pl(n - 2), rho),
    )


def make_sharded_level_ops_2d(
    spec: LevelMGSpec, mesh, d: int = 0, nsweeps: int | None = None,
    with_b: bool = False,
):
    """shard_map'ed relax / residual for a level sharded over a 2-D (x, y)
    pencil or 3-D (x, y, z) block mesh — the counterpart of the
    reference's full-boundary Copier exchange
    (VariableCoeffPoissonOperatorFactory.cpp:82-96), which communicates
    every sharded face, not just x slabs; the reference's box
    decomposition is 3-D by construction (domainSplit, SetGrids.cpp:54).
    Per half-sweep the one-cell boundary planes of every sharded axis ride
    ppermute, exchanged sequentially on the progressively extended array so
    corner/edge values ride along (though the 7-point stencil never reads
    them).

    Axes whose shard count is 1 (mesh axis absent, too small, or
    non-dividing — multigrid._shard_counts policy) are treated locally and
    left replicated over that mesh axis."""
    if nsweeps is None:
        nsweeps = spec.nsmooth
    from mg_ic_code_tpu.parallel.mesh import AXES
    from mg_ic_code_tpu.solver.multigrid import _shard_counts

    counts = _shard_counts(spec, d)
    kinds = spec.kinds
    rho = spec.rho[d]
    dx = spec.dx[d]
    alpha, beta = spec.alpha, spec.beta
    box = spec.boxes[d]
    n_loc = tuple(box.shape[ax] // counts[ax] for ax in range(3))
    pspec = P(*(AXES[ax] if counts[ax] > 1 else None for ax in range(3)))

    def ghost(u_loc):
        # sequential per-axis exchange of the progressively extended array
        # (later axes carry the earlier axes' halo planes -> corners/edges)
        ext = u_loc
        for ax in range(3):
            lo, hi = _axis_planes(
                ext, ax, kinds[ax][0], kinds[ax][1], rho,
                kinds[ax][0] == PERIODIC, counts[ax], AXES[ax],
            )
            ext = jnp.concatenate([lo, ext, hi], axis=ax)
        return ext

    def local_lo_sum(u_loc):
        s = sum(box.lo)
        for ax in range(3):
            if counts[ax] > 1:
                s = s + jax.lax.axis_index(AXES[ax]) * n_loc[ax]
        return s

    def relax_body(a, b, lam, u, rhs):
        lo_sum = local_lo_sum(u)

        def half(i, uu):
            u_gh = ghost(uu)
            lofu = st.apply_op(u_gh, a, b, alpha, beta, dx)
            upd = uu - lam * (lofu - rhs)
            ii = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 0)
            jj = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 1)
            kk = jax.lax.broadcasted_iota(jnp.int32, uu.shape, 2)
            par = (ii + jj + kk + lo_sum + i % 2) % 2
            return jnp.where(par == 0, upd, uu)

        return jax.lax.fori_loop(0, 2 * nsweeps, half, u)

    def residual_body(a, b, u, rhs):
        return st.residual(ghost(u), rhs, a, b, alpha, beta, dx)

    # variable bCoef (the reference's general-b GSRB/residual kernels,
    # VariableCoeffPoissonOperatorF.ChF:56-139) is cell-centred at update
    # points, so it shards like aCoef with NO halo of its own — only u
    # exchanges. `with_b` widens the shard_map signature accordingly
    # (VERDICT r3 stretch #10: a general-b sharded solve keeps the
    # hand-scheduled communication instead of falling to GSPMD).
    if with_b:
        relax_fn = jax.shard_map(
            relax_body, mesh=mesh,
            in_specs=(pspec,) * 5, out_specs=pspec,
        )
        residual_fn = jax.shard_map(
            residual_body, mesh=mesh,
            in_specs=(pspec,) * 4, out_specs=pspec,
        )
        return relax_fn, residual_fn
    relax_fn = jax.shard_map(
        lambda a, lam, u, rhs: relax_body(a, None, lam, u, rhs), mesh=mesh,
        in_specs=(pspec, pspec, pspec, pspec), out_specs=pspec,
    )
    residual_fn = jax.shard_map(
        lambda a, u, rhs: residual_body(a, None, u, rhs), mesh=mesh,
        in_specs=(pspec, pspec, pspec), out_specs=pspec,
    )
    return relax_fn, residual_fn


def sharded_relax(spec: LevelMGSpec, coefs: dict, d: int, u, rhs, n: int):
    """n red+black GSRB sweeps on an x-slab-sharded level: the overlapped
    explicit-halo XLA smoother (make_sharded_level_ops)."""
    relax_fn, _ = make_sharded_level_ops(spec, spec.mesh, d, nsweeps=n)
    return relax_fn(coefs["a"][d], coefs["lam"][d], u, rhs)


def sharded_residual(spec: LevelMGSpec, coefs: dict, d: int, u, rhs):
    """res = rhs - L(u) with the explicit ppermute ghost assembly (the
    sharded production counterpart of multigrid.residual_homog)."""
    _, residual_fn = make_sharded_level_ops(spec, spec.mesh, d)
    return residual_fn(coefs["a"][d], u, rhs)
