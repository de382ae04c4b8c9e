"""Composite (multi-level AMR) operator, V-cycle preconditioner and linear
solve.

JAX re-design of Chombo's MultilevelLinearOp + AMRMultiGrid as driven
by the reference (Main_PoissonSolver.cpp:103-184):

  * composite_apply/residual — the AMR hierarchy as ONE linear operator on
    the list of per-level arrays: each level applies L with quadratic
    coarse-fine ghosts interpolated from the same vector's coarser component
    (QuadCFInterp coupling) and physical BCs; no reflux, matching the
    reference's disabled reflux (VariableCoeffPoissonOperator.cpp:264-271).
  * amr_vcycle — correction-scheme V-cycle across AMR levels (homogeneous CF
    ghosts during smoothing), with the full MG depth chain + bottom solve
    below the base level.
  * precond — m_num_mg_iterations AMR V-cycles (MultilevelLinearOp::preCond).
  * solve_linear — BiCGStab over the composite vector with volume-weighted
    dots and max-norm convergence (solver.m_normType = 0).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig
from mg_ic_code_tpu.grid.geometry import HierarchyGeom
from mg_ic_code_tpu.ops import stencils as st
from mg_ic_code_tpu.ops.ghosts import fill_ghosts
from mg_ic_code_tpu.solver import multigrid as mg
from mg_ic_code_tpu.solver import reductions as red
from mg_ic_code_tpu.solver.bicgstab import BiCGStabResult, bicgstab


@dataclasses.dataclass(frozen=True)
class AMRSolverSpec:
    """Static description of the composite solver (hashable; jit-static)."""

    geom: HierarchyGeom
    alpha: float
    beta: float
    nsmooth: int
    num_mg_iterations: int
    avg_type: str
    level_specs: tuple[mg.LevelMGSpec, ...]
    tol: float = 1.0e-10
    max_iter: int = 100
    # stop when an iteration shrinks the residual by less than this factor
    # (Chombo BiCGStabSolver m_hang default 1e-8; params.txt `hang` key)
    hang: float = 1.0e-8
    # preCondSolverDepth (MultilevelLinearOp): when >= 0 the preconditioner
    # is itself an inner BiCGStab solve (loosely converged), preconditioned
    # by the AMR V-cycles — the reference's commented-out deep-precondition
    # mode (params.txt:32). -1 = plain V-cycle preconditioning.
    pre_cond_solver_depth: int = -1
    # run the MG preconditioner in reduced precision ("float32") while the
    # outer Krylov stays f64 (the preconditioner only needs smoother-grade
    # accuracy). None = same precision as the operands.
    precond_dtype: str | None = None
    # groups of same-shape sibling entries executed as ONE batched (vmapped)
    # sweep in amr_vcycle, with the stacked patch axis sharded over the
    # device mesh when an axis divides — the LoadBalance boxes->ranks task
    # parallelism (reference SetGrids.cpp:57,126). Computed by
    # make_amr_spec per cfg.forest_batching policy; () = fully sequential.
    batch_groups: tuple[tuple[int, ...], ...] = ()

    @property
    def num_levels(self) -> int:
        return self.geom.num_levels


def make_amr_spec(
    geom: HierarchyGeom, cfg: SolverConfig, mesh=None
) -> AMRSolverSpec:
    """`mesh` (jax.sharding.Mesh, optional) switches the hot smoother and
    residual onto the explicit shard_map + ppermute-halo production path
    wherever a depth's extent shards usefully (multigrid._shard_counts)."""
    level_specs = tuple(
        mg.make_level_spec(
            geom, l, cfg.alpha, cfg.beta, cfg.num_mg_smooth,
            cfg.coefficient_average_type,
            # depth chains below the base level only (ref ratio 2 puts all
            # intermediate MG depths under AMR level 0)
            with_depths=(l == 0),
            smoother=cfg.smoother,
            num_mg=cfg.num_mg,
            mesh=mesh,
            bottom=cfg.bottom_solver,
        )
        for l in range(geom.num_levels)
    )
    return AMRSolverSpec(
        geom=geom,
        alpha=cfg.alpha,
        beta=cfg.beta,
        nsmooth=cfg.num_mg_smooth,
        num_mg_iterations=cfg.num_mg_iterations,
        avg_type=cfg.coefficient_average_type,
        level_specs=level_specs,
        tol=cfg.tolerance,
        max_iter=cfg.max_iterations,
        hang=cfg.hang,
        pre_cond_solver_depth=cfg.pre_cond_solver_depth,
        # "auto" is double on every platform: whether an f32
        # preconditioner pays on a GPU has not been measured
        precond_dtype=(
            "float32" if cfg.precond_precision == "single" else None
        ),
        batch_groups=_sibling_batch_groups(
            geom, level_specs, getattr(cfg, "forest_batching", "auto"), mesh
        ),
    )


def _sibling_batch_groups(
    geom: HierarchyGeom, level_specs, mode: str, mesh
) -> tuple[tuple[int, ...], ...]:
    """Same-depth sibling entries that can run as one batched sweep.

    Batchable = identical box shape, face kinds, dx, and global checker
    parity (sum(lo) mod 2 — the GSRB colour mask depends on lo only through
    this). Policy: "off" = never; "force" = every group of >= 2 (the test
    mode, and the single-chip launch-reduction mode); "auto" = only groups
    a device mesh cannot slab-shard (multigrid._shard_counts == (1,1)):
    exactly the case where the sequential sweep would make every device
    recompute every patch, replicated (VERDICT r2 missing #1)."""
    if mode == "off":
        return ()
    by_key: dict = {}
    for e in range(1, geom.num_levels):
        ls = level_specs[e]
        key = (
            geom.depth_of(e), geom.boxes[e].shape, ls.kinds,
            sum(geom.boxes[e].lo) % 2, geom.dx[e],
        )
        by_key.setdefault(key, []).append(e)
    out = []
    for ents in by_key.values():
        if len(ents) < 2:
            continue
        if mode == "auto":
            if mesh is None:
                continue
            if mg._shard_counts(level_specs[ents[0]], 0) != (1, 1, 1):
                continue  # slab-sharded patches already use the whole mesh
        out.append(tuple(ents))
    return tuple(sorted(out))


def build_coefs(spec: AMRSolverSpec, a_list, b_list=None) -> tuple[dict, ...]:
    """Per-level coefficient structures (with depth chains under level 0).

    With mixed-precision preconditioning, each level also carries an "lp"
    sub-dict holding float32 casts of the whole depth chain."""
    out = []
    lp_dtype = jnp.float32 if spec.precond_dtype == "float32" else None
    for l in range(spec.num_levels):
        b0 = None if b_list is None else b_list[l]
        c = mg.build_level_coefs(spec.level_specs[l], a_list[l], b0)
        if lp_dtype is not None:
            cast = lambda t: tuple(
                None if x is None else x.astype(lp_dtype) for x in t
            )
            c = dict(c)
            c["lp"] = {k: cast(c[k]) for k in ("a", "b", "lam")}
            if c.get("binv") is not None:
                # the dense bottom inverse must ride along or the f32
                # preconditioner silently falls back to the launch-bound
                # BiCGStab bottom tower (code-review r2)
                c["lp"]["binv"] = c["binv"].astype(lp_dtype)
        out.append(c)
    return tuple(out)


def _lp(coefs_l: dict, use_lp: bool) -> dict:
    return coefs_l["lp"] if use_lp and "lp" in coefs_l else coefs_l


# --------------------------------------------------------------- operator


def composite_apply(
    spec: AMRSolverSpec, coefs, u_list, homogeneous_phys: bool = True,
    use_lp: bool = False,
):
    """A(u) on the composite vector. CF ghosts always couple to the coarser
    component of u itself (that coupling is part of the linear operator);
    the `homogeneous_phys` flag only zeroes physical BC values. `use_lp`
    selects the low-precision coefficient set (the preconditioner's inner
    residuals).

    The homogeneous form — every Krylov application — exploits that the
    operator is LINEAR in the CF ghost: A(u) = L_homog(u_l) minus the
    coarse-ghost face term (cf_interp.add_cf_coarse_term), so each level
    pays the cheap homogeneous one-ring fill instead of the full
    inhomogeneous QuadCFInterp assembly (tangential upsampling + edge
    padding per axis) that fill_ghosts rebuilds per apply — the dominant
    solve-phase graph after the preconditioner (VERDICT r3 next #5). The
    split is exact up to FLOP reassociation: the ghost value decomposes as
    (w0·u0 + w1·u1) + W_COARSE·plane and only face-adjacent ghosts reach
    the 7-point stencil."""
    from mg_ic_code_tpu.ops import cf_interp as _cfi

    geom = spec.geom
    out = []
    for l in range(spec.num_levels):
        c = _lp(coefs[l], use_lp)
        if homogeneous_phys:
            au = mg.apply_homog(spec.level_specs[l], c, 0, u_list[l])
            if l > 0:
                au = _cfi.add_cf_coarse_term(
                    au, geom, l, u_list[geom.parent[l]],
                    -spec.beta / geom.dx[l] ** 2, c["b"][0],
                )
            out.append(au)
        else:
            # inhomogeneous physical BCs (the initial residual only): the
            # full QuadCFInterp + BC-value ghost assembly
            u_gh = fill_ghosts(
                u_list[l], geom, l,
                coarse_u=u_list[geom.parent[l]] if l > 0 else None,
                homogeneous_phys=False,
            )
            out.append(
                st.apply_op(
                    u_gh, c["a"][0], c["b"][0], spec.alpha, spec.beta,
                    geom.dx[l],
                )
            )
    return out


def composite_residual(
    spec: AMRSolverSpec, coefs, u_list, rhs_list, homogeneous_phys: bool = True
):
    au = composite_apply(spec, coefs, u_list, homogeneous_phys)
    return [r - a for r, a in zip(rhs_list, au)]


# ----------------------------------------------------------------- V-cycle


def _stack_patches(arrs, mesh):
    """Stack per-patch arrays into a (P, nx, ny, nz) batch and, when a mesh
    axis divides the patch count, constrain the patch axis onto it so the
    siblings execute CONCURRENTLY on disjoint device subsets (the
    LoadBalance placement role). No usable axis -> replicated batch (still
    one launch instead of P)."""
    s = jnp.stack(arrs)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from mg_ic_code_tpu.parallel import mesh as pmesh

        name = pmesh.patch_axis(mesh, s.shape[0])
        if name is not None:
            s = jax.lax.with_sharding_constraint(
                s, NamedSharding(mesh, P(name))
            )
    return s


def _batchable(spec: AMRSolverSpec, coefs, depth_entries) -> list:
    """Split a depth's entries into [(group tuple) | single entry, ...] in
    entry order, honouring spec.batch_groups (b must be constant for the
    batched XLA body)."""
    in_group = {}
    for g in spec.batch_groups:
        for ent in g:
            in_group[ent] = g
    plan, seen = [], set()
    for l in depth_entries:
        if l in seen:
            continue
        g = in_group.get(l)
        if g is not None and coefs[g[0]].get("b", (None,))[0] is None:
            plan.append(g)
            seen.update(g)
        else:
            plan.append(l)
            seen.add(l)
    return plan


def amr_vcycle(spec: AMRSolverSpec, coefs, r_list, use_lp: bool = False):
    """One AMR V-cycle on the correction equation A e = r, from zero initial
    correction. Downsweep smooths each level with homogeneous CF ghosts and
    replaces the covered part of the next-coarser residual with the
    restricted fine residual; the base level runs the full MG depth chain;
    upsweep prolongs (piecewise-constant) and post-smooths.

    Sibling patches in spec.batch_groups run as ONE vmapped sweep over the
    stacked patch axis (sharded across the mesh when possible) instead of a
    sequential Python loop — the forest counterpart of LoadBalance's
    box->rank concurrency (SetGrids.cpp:57,126). The batched body is the
    same GSRB math as the sequential XLA path, so results are identical.

    The batched and single-entry branches are intentionally SEPARATE
    implementations: the single-entry path goes through mg.relax (and so
    through ops/dispatch, which may pick the GPU smoother kernel), while
    the batched body is the vmapped bare-array XLA sweep — a batch of one
    would silently trade the kernel for the XLA body.
    Equality of the two bodies is CI-locked (tests/test_forest.py)."""
    geom = spec.geom
    nl = spec.num_levels
    r = list(r_list)
    e: list = [None] * nl
    mesh = spec.level_specs[0].mesh

    # downsweep: depths descending — every child restricts into its parent
    # before the parent's depth runs; sibling patches write DISJOINT
    # covered regions, so within-depth order is free
    for depth in range(geom.max_depth, 0, -1):
        for item in _batchable(spec, coefs, geom.entries_at_depth(depth)):
            if isinstance(item, tuple):
                g = item
                ls = spec.level_specs[g[0]]
                cls = [_lp(coefs[x], use_lp) for x in g]
                a_b = _stack_patches([c["a"][0] for c in cls], mesh)
                lam_b = _stack_patches([c["lam"][0] for c in cls], mesh)
                r_b = _stack_patches([r[x] for x in g], mesh)
                el_b = jax.vmap(
                    lambda a, lam, rr: mg.relax_xla(
                        ls, 0, a, lam, jnp.zeros_like(rr), rr, spec.nsmooth
                    )
                )(a_b, lam_b, r_b)
                res_b = jax.vmap(
                    lambda a, u, rr: mg.residual_xla(ls, 0, a, u, rr)
                )(a_b, el_b, r_b)
                rc_b = jax.vmap(st.restrict_full)(res_b)
                for i, x in enumerate(g):
                    p = geom.parent[x]
                    r[p] = r[p].at[geom.child_slices(p, x)].set(rc_b[i])
                    e[x] = el_b[i]
            else:
                l = item
                ls = spec.level_specs[l]
                cl = _lp(coefs[l], use_lp)
                el = jnp.zeros_like(r[l])
                el = mg.relax(ls, cl, 0, el, r[l], spec.nsmooth)
                res_l = mg.residual_homog(ls, cl, 0, el, r[l])
                rc = st.restrict_full(res_l)
                p = geom.parent[l]
                r[p] = r[p].at[geom.child_slices(p, l)].set(rc)
                e[l] = el

    e[0] = mg.mg_vcycle(
        spec.level_specs[0], _lp(coefs[0], use_lp), jnp.zeros_like(r[0]), r[0]
    )

    # upsweep: depths ascending — every parent's correction is complete
    # before its children prolong from it
    for depth in range(1, geom.max_depth + 1):
        for item in _batchable(spec, coefs, geom.entries_at_depth(depth)):
            if isinstance(item, tuple):
                g = item
                ls = spec.level_specs[g[0]]
                cls = [_lp(coefs[x], use_lp) for x in g]
                a_b = _stack_patches([c["a"][0] for c in cls], mesh)
                lam_b = _stack_patches([c["lam"][0] for c in cls], mesh)
                # coarse gathers + CF rhs folds are entry-specific slicing
                # (cheap); the expensive smoothing is batched
                u_b = _stack_patches(
                    [
                        st.prolong_inc(
                            e[x], e[geom.parent[x]][
                                geom.child_slices(geom.parent[x], x)
                            ]
                        )
                        for x in g
                    ],
                    mesh,
                )
                rhs_b = _stack_patches(
                    [
                        mg.cf_folded_rhs(ls, geom, x, r[x], e[geom.parent[x]])
                        for x in g
                    ],
                    mesh,
                )
                eg_b = jax.vmap(
                    lambda a, lam, u, rr: mg.relax_xla(
                        ls, 0, a, lam, u, rr, spec.nsmooth
                    )
                )(a_b, lam_b, u_b, rhs_b)
                for i, x in enumerate(g):
                    e[x] = eg_b[i]
            else:
                l = item
                ls = spec.level_specs[l]
                p = geom.parent[l]
                ec = e[p][geom.child_slices(p, l)]
                e[l] = st.prolong_inc(e[l], ec)
                # post-smooth with CF ghosts interpolated from the coarse
                # correction (homogeneous ghosts here amplify the CF
                # mismatch by 1/dx^2 per level — see mg.relax_cf)
                e[l] = mg.relax_cf(
                    ls, _lp(coefs[l], use_lp), e[l], r[l], spec.nsmooth,
                    geom, l, e[p],
                )
    return e


def precond(spec: AMRSolverSpec, coefs, r_list):
    """MultilevelLinearOp::preCond — m_num_mg_iterations AMR-MG iterations,
    each a composite-residual evaluation plus a V-cycle.

    With precond_dtype set, the whole preconditioner runs in reduced
    precision (cast in, cast out); the outer Krylov arithmetic stays in the
    operand dtype. With pre_cond_solver_depth >= 0 the V-cycle chain wraps
    into an inner loosely-converged BiCGStab (deep-precondition mode)."""
    if spec.pre_cond_solver_depth >= 0:
        inner = bicgstab(
            functools.partial(composite_apply, spec, coefs),
            r_list,
            precond_fn=functools.partial(_vcycle_precond, spec, coefs),
            dot_fn=functools.partial(red.composite_dot, geom=spec.geom),
            norm_fn=functools.partial(
                red.composite_max_norm, geom=spec.geom
            ),
            tol=1.0e-4,
            max_iter=8 + 4 * spec.pre_cond_solver_depth,
        )
        return inner.x
    return _vcycle_precond(spec, coefs, r_list)


def _vcycle_precond(spec: AMRSolverSpec, coefs, r_list):
    """The plain m_num_mg_iterations-V-cycle preconditioner body."""
    out_dtype = r_list[0].dtype
    use_lp = (
        spec.precond_dtype == "float32" and out_dtype == jnp.float64
    )
    if use_lp:
        r_list = [r.astype(jnp.float32) for r in r_list]
    e = [jnp.zeros_like(r) for r in r_list]
    for it in range(spec.num_mg_iterations):
        res = (
            r_list
            if it == 0
            else _composite_residual_coefs(
                spec, coefs, e, r_list, use_lp
            )
        )
        de = amr_vcycle(spec, coefs, res, use_lp)
        e = [a + b for a, b in zip(e, de)]
    if use_lp:
        e = [x.astype(out_dtype) for x in e]
    return e


def _composite_residual_coefs(spec, coefs, u_list, rhs_list, use_lp):
    """Composite residual with the (possibly low-precision) coefficient
    set, for the inner precond iterations.

    Routed through the LEVEL residual (mg.residual_homog) rather than
    rhs - composite_apply: the level residual takes the explicit-halo
    path on sharded levels, and elsewhere (st.residual) is literally
    rhs - apply_op, so the unsharded result is unchanged bitwise. The CF
    coarse-ghost face term — part of the composite operator
    (composite_apply adds it with scale -beta/dx^2) — is removed
    afterwards with the negated scale: res = (r - L_homog(u)) - T. The
    reassociation shifts CF-face cells at roundoff only, which the outer
    f64 Krylov absorbs."""
    from mg_ic_code_tpu.ops import cf_interp as _cfi

    geom = spec.geom
    out = []
    for l in range(spec.num_levels):
        c = _lp(coefs[l], use_lp)
        res = mg.residual_homog(
            spec.level_specs[l], c, 0, u_list[l], rhs_list[l]
        )
        if l > 0:
            res = _cfi.add_cf_coarse_term(
                res, geom, l, u_list[geom.parent[l]],
                spec.beta / geom.dx[l] ** 2, c["b"][0],
            )
        out.append(res)
    return out


# ------------------------------------------------------------------ solve


def solve_linear(
    spec: AMRSolverSpec,
    coefs,
    rhs_list,
    x0_list=None,
    tol: float | None = None,
    max_iter: int | None = None,
) -> BiCGStabResult:
    """BiCGStab on the composite system, preconditioned by AMR multigrid.

    Inhomogeneous physical BCs are folded into the initial residual (the
    Krylov iteration itself runs with homogeneous BCs), as Chombo's
    solver.define(..., homogeneousBC=false) + solve() arrangement does.
    """
    geom = spec.geom
    if x0_list is None:
        x0_list = [jnp.zeros_like(r) for r in rhs_list]

    r0 = composite_residual(spec, coefs, x0_list, rhs_list, False)

    result = bicgstab(
        functools.partial(composite_apply, spec, coefs),
        r0,
        precond_fn=functools.partial(precond, spec, coefs),
        dot_fn=functools.partial(red.composite_dot, geom=geom),
        norm_fn=functools.partial(red.composite_max_norm, geom=geom),
        tol=spec.tol if tol is None else tol,
        max_iter=spec.max_iter if max_iter is None else max_iter,
        hang=spec.hang,
    )
    x = [a + b for a, b in zip(x0_list, result.x)]
    return result._replace(x=x)


@functools.partial(jax.jit, static_argnums=(0,))
def solve_linear_jit(spec: AMRSolverSpec, coefs, rhs_list, x0_list):
    return solve_linear(spec, coefs, rhs_list, x0_list)


composite_apply_jit = jax.jit(composite_apply, static_argnums=(0, 3, 4))
composite_residual_jit = jax.jit(composite_residual, static_argnums=(0, 4))
amr_vcycle_jit = jax.jit(amr_vcycle, static_argnums=(0,))
precond_jit = jax.jit(precond, static_argnums=(0,))
build_coefs_jit = jax.jit(build_coefs, static_argnums=(0,))
