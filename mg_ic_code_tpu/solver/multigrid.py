"""Single-level geometric multigrid: smoothing, depth chain, bottom solve.

JAX re-design of the per-level half of Chombo's AMRMultiGrid +
the reference operator's level contract (VariableCoeffPoissonOperator.cpp):
  * relax            — numMGsmooth red-black GSRB sweeps, each colour
                       preceded by a homogeneous ghost refresh (levelGSRB,
                       :273-332: homogeneousCFInterp + exchange + BCs)
  * residual/restrict— fused residual + full-weighting restriction
                       (restrictResidual :151-194)
  * mg_vcycle        — V-cycle down the depth chain built by MGnewOp
                       (VariableCoeffPoissonOperatorFactory.cpp:139-234),
                       with coefficients pre-coarsened arithmetically or
                       harmonically
  * bottom_solve     — unpreconditioned-ish BiCGStab at the coarsest depth
                       with the reference's preCond (dpsi = lambda*rhs then 2
                       GSRB relaxes, :72-104) as its preconditioner

On one chip a dense level needs no halo exchange between colours — only the
cheap one-ring ghost refresh, which XLA fuses with the sweep.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import HierarchyGeom
from mg_ic_code_tpu.ops import dispatch, gsrb_gpu
from mg_ic_code_tpu.ops import stencils as st
from mg_ic_code_tpu.ops.ghosts import (
    CF, PHYS_DIRICHLET, FaceKinds, face_kinds, fill_ghosts_homogeneous,
)
from mg_ic_code_tpu.solver.bicgstab import bicgstab


@dataclasses.dataclass(frozen=True)
class LevelMGSpec:
    """Static description of one AMR level's MG structure (hashable)."""

    kinds: FaceKinds
    boxes: tuple[Box, ...]  # depth chain; depth 0 = the AMR level box
    dx: tuple[float, ...]
    rho: tuple[float, ...]  # CF homogeneous-ghost ratio per depth
    alpha: float
    beta: float
    nsmooth: int
    avg_type: str = "arithmetic"
    bottom_iters: int = 60
    bottom_tol: float = 1.0e-12
    # MG cycle shape below this level: 1 = V-cycle, 2 = W-cycle (Chombo's
    # numMG / the params.txt `num_mg` key)
    num_mg: int = 1
    # smoother backend: "auto" runs the fused GPU kernel where
    # ops/dispatch.use_gsrb_kernel allows it; "xla" always runs the XLA body
    smoother: str = "auto"
    # coarsest-depth solve: "auto" = dense direct solve when the bottom box
    # is small enough, else preconditioned BiCGStab (Chombo's default
    # AMRMultiGrid bottom solver); "direct" / "bicgstab" force one
    bottom: str = "auto"
    # device mesh for the explicit-halo production path: when set and the
    # mesh's x axis usefully divides a depth's extent, relax/residual run
    # inside shard_map with ppermute halo exchange (parallel/halo.py) — the
    # counterpart of the reference's per-smooth MPI exchange
    # (VariableCoeffPoissonOperator.cpp:301). None = single device or
    # implicit GSPMD sharding.
    mesh: object = None

    @property
    def ndepths(self) -> int:
        return len(self.boxes)


def make_level_spec(
    geom: HierarchyGeom,
    level: int,
    alpha: float,
    beta: float,
    nsmooth: int,
    avg_type: str = "arithmetic",
    with_depths: bool = True,
    min_size: int = 4,
    smoother: str = "auto",
    num_mg: int = 1,
    mesh=None,
    bottom: str = "auto",
) -> LevelMGSpec:
    boxes = geom.mg_depth_boxes(level, min_size) if with_depths else (
        geom.boxes[level],
    )
    dx0 = geom.dx[level]
    # dxCrse stays the AMR-coarse spacing (2*dx0) while depth dx doubles:
    # rho_d = dxCrse / dx_d = 2^(1-d)  (Chombo keeps m_dxCrse fixed per op)
    return LevelMGSpec(
        kinds=face_kinds(geom, level),
        boxes=boxes,
        dx=tuple(dx0 * 2**d for d in range(len(boxes))),
        rho=tuple(2.0 ** (1 - d) for d in range(len(boxes))),
        alpha=alpha,
        beta=beta,
        nsmooth=nsmooth,
        avg_type=avg_type,
        smoother=smoother,
        num_mg=num_mg,
        mesh=mesh,
        bottom=bottom,
    )


# bottom boxes up to this many cells get the dense direct solve (the
# factorised operator is tiny next to the level arrays: 512^2 f64 = 2 MB)
DIRECT_BOTTOM_MAX_CELLS = 1024


def _use_direct_bottom(spec: LevelMGSpec) -> bool:
    if spec.bottom == "bicgstab":
        return False
    # a (near-)singular bottom operator (alpha ~ 0 with no Dirichlet/CF
    # face, e.g. pure-Poisson periodic) has a (near-)constant null vector:
    # the dense inverse would be Inf/NaN garbage where BiCGStab stays in
    # the range space and degrades gracefully — never densely invert it.
    # "Near zero" is judged against the Laplacian diagonal beta/dx^2 with
    # aCoef assumed O(1) (the physics pins aCoef that way, ADVICE r2): a
    # mass term below ~1e-10 of the stencil scale puts the condition number
    # past what a dense inverse can resolve.
    dx_bot = spec.dx[-1]
    if abs(spec.alpha) <= 1e-10 * abs(spec.beta) / dx_bot**2 and not any(
        k in (PHYS_DIRICHLET, CF) for ax in spec.kinds for k in ax
    ):
        return False
    cells = 1
    for s in spec.boxes[-1].shape:
        cells *= s
    return spec.bottom == "direct" or cells <= DIRECT_BOTTOM_MAX_CELLS


def build_level_coefs(spec: LevelMGSpec, a0, b0=None) -> dict:
    """Coarsen aCoef/bCoef down the depth chain (MGnewOp's CoarseAverage,
    arithmetic or harmonic) and precompute lambda at each depth.

    When the coarsest depth is small, additionally materialise the dense
    bottom operator's inverse: the coarse solve then costs ONE matmul
    instead of a BiCGStab iteration tower (dozens of tiny launch-bound
    ops). The operator is linear and fixed
    per coefficient build, so this is exact, not approximate."""
    a_chain, b_chain, lam_chain = [a0], [b0], []
    for d in range(1, spec.ndepths):
        a_chain.append(st.coarsen_coef(a_chain[-1], spec.avg_type))
        b_chain.append(
            None if b0 is None else st.coarsen_coef(b_chain[-1], spec.avg_type)
        )
    for d in range(spec.ndepths):
        lam_chain.append(
            st.gsrb_lambda(a_chain[d], spec.alpha, spec.beta, spec.dx[d])
        )
    coefs = {"a": tuple(a_chain), "b": tuple(b_chain), "lam": tuple(lam_chain)}
    if _use_direct_bottom(spec):
        coefs["binv"] = _bottom_inverse(spec, coefs)
    return coefs


def _bottom_inverse(spec: LevelMGSpec, coefs: dict):
    """Dense inverse of the homogeneous-BC operator at the coarsest depth,
    built by applying the operator to the identity basis (vmapped)."""
    d = spec.ndepths - 1
    shape = spec.boxes[d].shape
    m = shape[0] * shape[1] * shape[2]
    dtype = coefs["a"][d].dtype
    eye = jnp.eye(m, dtype=dtype)

    def apply_vec(v):
        return apply_homog(spec, coefs, d, v.reshape(shape)).ravel()

    cols = jax.vmap(apply_vec)(eye)  # row i = A @ e_i = column i of A
    return jnp.linalg.inv(cols.T)


def _ghost(spec: LevelMGSpec, d: int, u):
    return fill_ghosts_homogeneous(u, spec.kinds, spec.rho[d])


def gsrb_half_sweep(spec: LevelMGSpec, coefs: dict, d: int, u, rhs, color):
    """One colour of a GSRB sweep, preceded by its ghost refresh (levelGSRB's
    per-colour CFInterp/exchange/BC sequence). `color` may be traced."""
    u_gh = _ghost(spec, d, u)
    return st.gsrb_color(
        u_gh, rhs, coefs["a"][d], coefs["b"][d], coefs["lam"][d],
        spec.alpha, spec.beta, spec.dx[d], spec.boxes[d].lo, color,
    )


def gsrb_sweep(spec: LevelMGSpec, coefs: dict, d: int, u, rhs):
    """One full red+black GSRB sweep at depth d."""
    for color in (0, 1):
        u = gsrb_half_sweep(spec, coefs, d, u, rhs, color)
    return u


def _shard_counts(spec: LevelMGSpec, d: int) -> tuple[int, int, int]:
    """(x, y, z) shard counts of the explicit-halo production path at depth
    d: an axis counts as sharded only when the mesh axis divides this
    depth's extent leaving enough local rows (the mesh.level_spec policy).
    Depths too coarse to shard run the single-device path on (replicated)
    arrays — the analogue of Chombo's implicit gather of coarse MG levels
    onto few ranks."""
    if spec.mesh is None:
        return 1, 1, 1
    from mg_ic_code_tpu.parallel.mesh import AXES, MIN_LOCAL_NX

    counts = []
    for arr_axis, name in enumerate(AXES):
        ndev = spec.mesh.shape.get(name, 1)
        n = spec.boxes[d].shape[arr_axis]
        counts.append(
            ndev
            if ndev > 1 and n % ndev == 0 and n // ndev >= MIN_LOCAL_NX
            else 1
        )
    return tuple(counts)


def relax(spec: LevelMGSpec, coefs: dict, d: int, u, rhs, n: int):
    """n red+black sweeps.

    Sharded levels run the explicit-halo XLA smoother (parallel/halo.py).
    Elsewhere ops/dispatch decides between the fused GPU kernel (one
    launch per sweep, ops/gsrb_gpu.py) and the XLA body: a fori_loop with
    the colour as a traced value, so the compiled graph holds ONE
    half-sweep body regardless of n.
    """
    if n <= 0:
        return u
    b = coefs["b"][d]
    counts = _shard_counts(spec, d)
    if counts != (1, 1, 1):
        from mg_ic_code_tpu.parallel import halo

        if b is None and counts[1:] == (1, 1):
            return halo.sharded_relax(spec, coefs, d, u, rhs, n)
        # pencil/block meshes, and variable bCoef on any sharded level
        # (b is cell-centred and needs no halo of its own)
        relax_fn, _ = halo.make_sharded_level_ops_2d(
            spec, spec.mesh, d, nsweeps=n, with_b=b is not None
        )
        args = (coefs["a"][d],) + ((b,) if b is not None else ())
        return relax_fn(*args, coefs["lam"][d], u, rhs)

    # on a mesh, replicated (too small to shard) levels stay on XLA too:
    # the kernel is not written for sharded operands
    if dispatch.use_gsrb_kernel(
        spec.smoother, dispatch.platform(), u.dtype, u.shape,
        has_b=b is not None, sharded=spec.mesh is not None,
    ):
        return gsrb_gpu.gsrb_relax(
            u, rhs, coefs["a"][d], coefs["lam"][d], kinds=spec.kinds,
            rho=spec.rho[d], alpha=spec.alpha, beta=spec.beta,
            dx=spec.dx[d], lo=spec.boxes[d].lo, nsweeps=n,
        )

    def body(i, uu):
        return gsrb_half_sweep(spec, coefs, d, uu, rhs, i % 2)

    return jax.lax.fori_loop(0, 2 * n, body, u)


def relax_cf(
    spec: LevelMGSpec, coefs: dict, u, rhs, n: int,
    geom: HierarchyGeom, level: int, coarse_u,
):
    """AMR-level relaxation with coarse-fine ghosts interpolated from the
    (now known) coarse correction — the up-sweep post-smooth of AMR-FAC.

    Using homogeneous CF ghosts after prolongation leaves an O(e_coarse)
    ghost error that the operator amplifies by 1/dx^2 per level; with 7
    levels that turns the V-cycle into an amplifier (measured ~6x residual
    growth per level). Physical BCs stay homogeneous (correction equation).

    Implementation: the quadratic CF ghost is w0*u0 + w1*u1 + (8/15)*phi_c
    with phi_c CONSTANT during the post-smooth, and the GSRB update is
    linear in the ghost — so the coarse term folds exactly into the rhs
    (rhs += beta/dx^2 * (8/15)*phi_c at CF-face cells) and the smoothing
    itself runs through `relax`'s homogeneous smoother instead of a
    per-pass ghost-fill loop."""
    if n <= 0:
        return u

    b = coefs["b"][0]
    if b is None and level > 0:
        rhs_cf = cf_folded_rhs(spec, geom, level, rhs, coarse_u)
        return relax(spec, coefs, 0, u, rhs_cf, n)

    # variable bCoef: no folded identity — per-pass ghost-fill XLA loop
    from mg_ic_code_tpu.ops.ghosts import fill_ghosts

    def body(i, uu):
        u_gh = fill_ghosts(
            uu, geom, level, coarse_u=coarse_u, homogeneous_phys=True
        )
        return st.gsrb_color(
            u_gh, rhs, coefs["a"][0], coefs["b"][0], coefs["lam"][0],
            spec.alpha, spec.beta, spec.dx[0], spec.boxes[0].lo, i % 2,
        )

    return jax.lax.fori_loop(0, 2 * n, body, u)


def cf_folded_rhs(spec: LevelMGSpec, geom: HierarchyGeom, level: int,
                  rhs, coarse_u):
    """Fold the (constant-during-post-smooth) coarse CF ghost term into the
    rhs: the quadratic CF ghost is w0*u0 + w1*u1 + (8/15)*phi_c, linear in
    the ghost, so the coarse contribution becomes
    rhs += beta/dx^2 * (8/15)*phi_c at CF-face cells — letting the
    smoothing itself run through `relax`'s homogeneous kernels. The face
    walk (cf_interp.cf_faces) includes non-spanning periodic faces at the
    domain boundary, whose coarse neighbour wraps — the same
    classification the ghost fill uses."""
    from mg_ic_code_tpu.ops import cf_interp as _cfi

    b_inv = spec.beta / (spec.dx[0] * spec.dx[0])
    return _cfi.add_cf_coarse_term(rhs, geom, level, coarse_u, b_inv)


def relax_xla(spec: LevelMGSpec, d: int, a, lam, u, rhs, n: int):
    """Pure-XLA homogeneous GSRB relaxation taking bare arrays (no coefs
    dict), vmappable over a leading patch axis — the batched-sibling
    execution path (solver.composite's forest LoadBalance role). Identical
    math to the XLA fallback body of `relax` (b None)."""
    def body(i, uu):
        u_gh = _ghost(spec, d, uu)
        return st.gsrb_color(
            u_gh, rhs, a, None, lam, spec.alpha, spec.beta, spec.dx[d],
            spec.boxes[d].lo, i % 2,
        )

    return jax.lax.fori_loop(0, 2 * n, body, u)


def residual_xla(spec: LevelMGSpec, d: int, a, u, rhs):
    """Pure-XLA homogeneous residual on bare arrays (vmappable)."""
    return st.residual(
        _ghost(spec, d, u), rhs, a, None, spec.alpha, spec.beta, spec.dx[d]
    )


def residual_homog(spec: LevelMGSpec, coefs: dict, d: int, u, rhs):
    b = coefs["b"][d]
    counts = _shard_counts(spec, d)
    if counts != (1, 1, 1):
        from mg_ic_code_tpu.parallel import halo

        if b is None and counts[1:] == (1, 1):
            return halo.sharded_residual(spec, coefs, d, u, rhs)
        _, residual_fn = halo.make_sharded_level_ops_2d(
            spec, spec.mesh, d, with_b=b is not None
        )
        args = (coefs["a"][d],) + ((b,) if b is not None else ())
        return residual_fn(*args, u, rhs)
    return st.residual(
        _ghost(spec, d, u), rhs, coefs["a"][d], coefs["b"][d],
        spec.alpha, spec.beta, spec.dx[d],
    )


def apply_homog(spec: LevelMGSpec, coefs: dict, d: int, u):
    return st.apply_op(
        _ghost(spec, d, u), coefs["a"][d], coefs["b"][d],
        spec.alpha, spec.beta, spec.dx[d],
    )


def jacobi_sweep(spec: LevelMGSpec, coefs: dict, d: int, u, rhs,
                 weight: float = 0.5):
    """Weighted Jacobi relaxation: u += w * lambda * (rhs - L(u)) — the
    reference's levelJacobi alternative smoother
    (VariableCoeffPoissonOperator.cpp:360-385, weight 0.5)."""
    res = residual_homog(spec, coefs, d, u, rhs)
    return u + weight * coefs["lam"][d] * res


def level_precond(spec: LevelMGSpec, coefs: dict, d: int, rhs):
    """The reference's smoother-grade preconditioner: u = lambda * rhs
    followed by 2 GSRB relaxations (preCond,
    VariableCoeffPoissonOperator.cpp:72-104)."""
    u = coefs["lam"][d] * rhs
    return relax(spec, coefs, d, u, rhs, 2)


def bottom_solve(spec: LevelMGSpec, coefs: dict, d: int, u, rhs):
    """Coarsest-depth solve: dense direct solve when precomputed (small
    bottom boxes — one matmul), else BiCGStab preconditioned by the level
    preCond (Chombo's AMRMultiGrid default bottom solver is BiCGStab)."""
    res = residual_homog(spec, coefs, d, u, rhs)
    if coefs.get("binv") is not None:
        # one step of iterative refinement: e <- e + X(r - A e) contracts
        # the error by ||I - AX|| per step, so an inverse left at ~1e-k
        # residual still yields a near-exact bottom solve (guards the
        # ill-conditioned tail the static singularity check cannot see).
        # HIGHEST: an f32 matmul may otherwise run in TF32 on a GPU.
        binv = coefs["binv"]
        hi = jax.lax.Precision.HIGHEST
        e = jnp.matmul(binv, res.ravel(), precision=hi).reshape(res.shape)
        r2 = res - apply_homog(spec, coefs, d, e)
        e = e + jnp.matmul(binv, r2.ravel(), precision=hi).reshape(res.shape)
        return u + e
    # f32 (mixed-precision preconditioner) cannot reach the f64 bottom
    # tolerance; stop at what the precision supports
    tol = spec.bottom_tol if u.dtype == jnp.float64 else max(
        spec.bottom_tol, 1.0e-6
    )
    out = bicgstab(
        functools.partial(apply_homog, spec, coefs, d),
        res,
        precond_fn=functools.partial(level_precond, spec, coefs, d),
        tol=tol,
        max_iter=spec.bottom_iters,
    )
    return u + out.x


def mg_vcycle(spec: LevelMGSpec, coefs: dict, u, rhs, d: int = 0):
    """Correction-scheme gamma-cycle over the depth chain: pre-smooth, fused
    restrict(residual), recurse gamma times (gamma = spec.num_mg: 1 gives
    the V-cycle, 2 the W-cycle — Chombo's numMG), piecewise-constant
    prolong, post-smooth."""
    u = relax(spec, coefs, d, u, rhs, spec.nsmooth)
    if d + 1 < spec.ndepths:
        rc = st.restrict_residual(
            _ghost(spec, d, u), rhs, coefs["a"][d], coefs["b"][d],
            spec.alpha, spec.beta, spec.dx[d],
        )
        ec = jnp.zeros_like(rc)
        for _ in range(max(spec.num_mg, 1)):
            ec = mg_vcycle(spec, coefs, ec, rc, d + 1)
        u = st.prolong_inc(u, ec)
        u = relax(spec, coefs, d, u, rhs, spec.nsmooth)
    else:
        u = bottom_solve(spec, coefs, d, u, rhs)
    return u


# jitted entry points (spec and depth are static)
mg_vcycle_jit = jax.jit(mg_vcycle, static_argnums=(0, 4))
relax_jit = jax.jit(relax, static_argnums=(0, 2, 5))
residual_homog_jit = jax.jit(residual_homog, static_argnums=(0, 2))
build_level_coefs_jit = jax.jit(build_level_coefs, static_argnums=(0,))
