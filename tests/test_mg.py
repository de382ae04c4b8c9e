import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from mg_ic_code_tpu.config import SolverConfig
from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec, HierarchyGeom, single_level_geom
from mg_ic_code_tpu.solver import composite as comp
from mg_ic_code_tpu.solver import multigrid as mg
from mg_ic_code_tpu.solver import reductions as red

RNG = np.random.default_rng(7)


def poisson_cfg(**kw):
    base = dict(
        alpha=0.0, beta=-1.0, max_level=0, n_cells=(16, 16, 16), L=1.0,
        num_mg_smooth=4, num_mg_iterations=1, max_iterations=60,
        tolerance=1e-10, is_periodic=False,
    )
    base.update(kw)
    return SolverConfig(**base)


def test_level_vcycle_contraction():
    """Residual contraction per V-cycle on constant-coefficient Dirichlet
    Poisson must be strongly < 1 (the reference's convergence oracle is
    exactly this kind of residual history, SURVEY §4)."""
    n = 16
    geom = single_level_geom(n, 1.0, BCSpec())
    spec = mg.make_level_spec(geom, 0, alpha=0.0, beta=-1.0, nsmooth=4)
    assert spec.ndepths >= 2
    a = jnp.zeros((n, n, n))
    coefs = mg.build_level_coefs(spec, a)
    rhs = jnp.asarray(RNG.standard_normal((n, n, n)))
    u = jnp.zeros_like(rhs)
    norms = [float(jnp.max(jnp.abs(mg.residual_homog_jit(spec, coefs, 0, u, rhs))))]
    for _ in range(4):
        u = mg.mg_vcycle_jit(spec, coefs, u, rhs)
        norms.append(
            float(jnp.max(jnp.abs(mg.residual_homog_jit(spec, coefs, 0, u, rhs))))
        )
    rates = [b / a for a, b in zip(norms, norms[1:])]
    assert max(rates) < 0.2, f"V-cycle contraction too weak: {norms}"


def test_level_vcycle_variable_coef():
    n = 16
    geom = single_level_geom(n, 1.0, BCSpec())
    spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=4,
                              avg_type="harmonic")
    a = jnp.asarray(RNG.uniform(0.5, 2.0, (n, n, n)))
    coefs = mg.build_level_coefs(spec, a)
    rhs = jnp.asarray(RNG.standard_normal((n, n, n)))
    u = jnp.zeros_like(rhs)
    r0 = float(jnp.max(jnp.abs(rhs)))
    for _ in range(6):
        u = mg.mg_vcycle_jit(spec, coefs, u, rhs)
    r = float(jnp.max(jnp.abs(mg.residual_homog_jit(spec, coefs, 0, u, rhs))))
    # 6 cycles at the observed ~0.14/cycle contraction
    assert r < 1e-4 * r0, f"V-cycles stalled: {r} vs {r0}"


def test_single_level_solve_analytic():
    """Solve +Lap(u) = rhs (alpha=0, beta=-1) with homogeneous Dirichlet;
    compare against the analytic product-of-sines solution: O(h^2)."""
    errs = []
    for n in (8, 16):
        cfg = poisson_cfg(n_cells=(n, n, n))
        geom = single_level_geom(n, 1.0, BCSpec())
        spec = comp.make_amr_spec(geom, cfg)
        x, y, z = geom.coords(0)
        u_exact = (
            np.sin(np.pi * (x + 0.5)) *
            np.sin(np.pi * (y + 0.5)) *
            np.sin(np.pi * (z + 0.5))
        )
        rhs = -3.0 * np.pi**2 * u_exact
        coefs = comp.build_coefs(spec, [jnp.zeros((n, n, n))])
        out = comp.solve_linear_jit(spec, coefs, [jnp.asarray(rhs)], [jnp.zeros((n, n, n))])
        assert bool(out.converged)
        err = float(jnp.max(jnp.abs(out.x[0] - u_exact)))
        errs.append(err)
    order = np.log2(errs[0] / errs[1])
    assert order > 1.7, f"not 2nd-order convergent: errs={errs}"


def test_composite_two_level_solve():
    """Two-level composite BiCGStab+AMR-MG drives the composite residual to
    tolerance (variable aCoef, Dirichlet BCs)."""
    dom0 = Box.from_shape((16, 16, 16))
    fine = Box.from_shape((16, 16, 16), lo=(8, 8, 8))
    geom = HierarchyGeom(
        boxes=(dom0, fine),
        domain_boxes=(dom0, dom0.refine(2)),
        dx=(1.0 / 16, 1.0 / 32),
        domain_length=(1.0, 1.0, 1.0),
        bc=BCSpec(),
    )
    cfg = poisson_cfg(alpha=1.0, max_level=1, num_mg_iterations=2)
    spec = comp.make_amr_spec(geom, cfg)
    a = [jnp.asarray(RNG.uniform(0.5, 1.5, geom.shape(l))) for l in range(2)]
    coefs = comp.build_coefs(spec, a)
    rhs = [jnp.asarray(RNG.standard_normal(geom.shape(l))) for l in range(2)]
    out = comp.solve_linear_jit(spec, coefs, rhs, [jnp.zeros_like(r) for r in rhs])
    res = comp.composite_residual_jit(spec, coefs, out.x, rhs, False)
    rel = float(red.composite_max_norm(res, geom)) / float(
        red.composite_max_norm(rhs, geom)
    )
    assert rel < 1e-9, f"composite residual too large: {rel}"
    assert bool(out.converged)


def test_composite_reductions_exclude_covered():
    dom0 = Box.from_shape((8, 8, 8))
    fine = Box.from_shape((8, 8, 8), lo=(4, 4, 4))
    geom = HierarchyGeom(
        boxes=(dom0, fine),
        domain_boxes=(dom0, dom0.refine(2)),
        dx=(0.125, 0.0625),
        domain_length=(1.0, 1.0, 1.0),
        bc=BCSpec(),
    )
    u0 = np.ones((8, 8, 8))
    u0[2:6, 2:6, 2:6] = 100.0  # covered region — must be ignored
    u1 = 2.0 * np.ones((8, 8, 8))
    mx = float(red.composite_max_norm([jnp.asarray(u0), jnp.asarray(u1)], geom))
    assert mx == 2.0
    s = float(red.composite_sum([jnp.asarray(u0), jnp.asarray(u1)], geom))
    want = (512 - 64) * 0.125**3 * 1.0 + 512 * 0.0625**3 * 2.0
    assert s == pytest.approx(want)


def test_mixed_precision_preconditioner():
    """f32 MG preconditioner + f64 outer BiCGStab still reaches the 1e-10
    relative tolerance (the mixed-precision mode)."""
    n = 16
    geom = single_level_geom(n, 1.0, BCSpec())
    cfg = poisson_cfg(alpha=1.0, precond_precision="single")
    spec = comp.make_amr_spec(geom, cfg)
    assert spec.precond_dtype == "float32"
    a = [jnp.asarray(RNG.uniform(0.5, 2.0, (n, n, n)))]
    rhs = [jnp.asarray(RNG.standard_normal((n, n, n)))]
    coefs = comp.build_coefs_jit(spec, a)
    assert coefs[0]["lp"]["a"][0].dtype == jnp.float32
    out = comp.solve_linear_jit(spec, coefs, rhs, [jnp.zeros_like(rhs[0])])
    assert bool(out.converged)
    rel = float(out.final_rnorm) / float(out.initial_rnorm)
    assert rel < 1e-10
    # and the answer matches the all-f64 solve
    cfg64 = poisson_cfg(alpha=1.0)
    spec64 = comp.make_amr_spec(geom, cfg64)
    coefs64 = comp.build_coefs_jit(spec64, a)
    ref = comp.solve_linear_jit(spec64, coefs64, rhs, [jnp.zeros_like(rhs[0])])
    np.testing.assert_allclose(np.asarray(out.x[0]), np.asarray(ref.x[0]),
                               rtol=1e-8, atol=1e-10)


def test_precond_precision_single_vs_double():
    """VERDICT r1 weak #8: the f32 preconditioner's bottom-solve tolerance
    silently floors at 1e-6 (multigrid.bottom_solve) — quantify its effect
    on the f64 OUTER convergence at tol 1e-10 on a stiff case (4 orders of
    coefficient contrast). The floor may cost at most a couple of extra
    outer Krylov iterations; it must never break convergence."""
    n = 16
    geom = single_level_geom(n, 1.0, BCSpec())
    # sharp double-peak aCoef: contrast ~1e4 across the box
    x, y, z = geom.coords(0)
    a_np = 1e-2 + 1e2 * (
        np.exp(-80.0 * ((x - 0.3) ** 2 + (y - 0.3) ** 2 + (z - 0.3) ** 2))
        + np.exp(-80.0 * ((x - 0.7) ** 2 + (y - 0.7) ** 2 + (z - 0.7) ** 2))
    )
    a = [jnp.asarray(a_np)]
    # local generator: must not perturb the shared module RNG stream
    rhs = [jnp.asarray(np.random.default_rng(123).standard_normal((n, n, n)))]
    iters = {}
    for precision in ("double", "single"):
        cfg = poisson_cfg(alpha=1.0, precond_precision=precision,
                          coefficient_average_type="harmonic")
        spec = comp.make_amr_spec(geom, cfg)
        coefs = comp.build_coefs_jit(spec, a)
        out = comp.solve_linear_jit(spec, coefs, rhs,
                                    [jnp.zeros_like(rhs[0])])
        assert bool(out.converged), f"{precision} failed to converge"
        assert float(out.final_rnorm / out.initial_rnorm) < 1e-10
        iters[precision] = int(out.iters)
    # the 1e-6 bottom floor costs at most 2 extra outer iterations here
    assert iters["single"] <= iters["double"] + 2, iters


def test_wcycle_contracts_faster_than_vcycle():
    """num_mg = 2 (W-cycle, the params.txt `num_mg` key) must contract at
    least as fast per cycle as the V-cycle."""
    n = 16
    geom = single_level_geom(n, 1.0, BCSpec())
    rates = {}
    for gamma in (1, 2):
        spec = mg.make_level_spec(geom, 0, alpha=0.0, beta=-1.0, nsmooth=2,
                                  num_mg=gamma)
        coefs = mg.build_level_coefs(spec, jnp.zeros((n, n, n)))
        rhs = jnp.asarray(RNG.standard_normal((n, n, n)))
        u = jnp.zeros_like(rhs)
        r0 = float(jnp.max(jnp.abs(rhs)))
        for _ in range(3):
            u = mg.mg_vcycle_jit(spec, coefs, u, rhs)
        r = float(jnp.max(jnp.abs(mg.residual_homog_jit(spec, coefs, 0, u, rhs))))
        rates[gamma] = (r / r0) ** (1 / 3)
    assert rates[2] <= rates[1] * 1.05, rates


def test_precond_solver_depth_mode():
    """preCondSolverDepth >= 0 wraps the V-cycles in an inner Krylov solve;
    the outer solve must still converge."""
    n = 16
    geom = single_level_geom(n, 1.0, BCSpec())
    cfg = poisson_cfg(alpha=1.0, pre_cond_solver_depth=1)
    spec = comp.make_amr_spec(geom, cfg)
    assert spec.pre_cond_solver_depth == 1
    a = [jnp.asarray(RNG.uniform(0.5, 2.0, (n, n, n)))]
    rhs = [jnp.asarray(RNG.standard_normal((n, n, n)))]
    coefs = comp.build_coefs_jit(spec, a)
    out = comp.solve_linear_jit(spec, coefs, rhs, [jnp.zeros_like(rhs[0])])
    assert bool(out.converged)
    assert float(out.final_rnorm / out.initial_rnorm) < 1e-10


def test_relax_cf_rhs_fold_matches_explicit_loop():
    """relax_cf's folded-rhs form (coarse CF ghost term moved into the
    rhs so homogeneous kernels smooth) must equal the explicit
    per-pass inhomogeneous ghost-fill loop to rounding."""
    import jax
    from mg_ic_code_tpu.ops.ghosts import fill_ghosts

    dom0 = Box.from_shape((16, 16, 16))
    fine = Box.from_shape((16, 16, 16), lo=(8, 8, 8))
    geom = HierarchyGeom(
        boxes=(dom0, fine),
        domain_boxes=(dom0, dom0.refine(2)),
        dx=(1.0 / 16, 1.0 / 32),
        domain_length=(1.0, 1.0, 1.0),
        bc=BCSpec(),
    )
    spec = mg.make_level_spec(geom, 1, alpha=1.0, beta=-1.0, nsmooth=4,
                              with_depths=False)
    a = jnp.asarray(RNG.uniform(0.5, 2.0, (16, 16, 16)))
    coefs = mg.build_level_coefs(spec, a)
    u = jnp.asarray(RNG.standard_normal((16, 16, 16)))
    rhs = jnp.asarray(RNG.standard_normal((16, 16, 16)))
    coarse_u = jnp.asarray(RNG.standard_normal((16, 16, 16)))

    got = mg.relax_cf(spec, coefs, u, rhs, 3, geom, 1, coarse_u)

    def body(i, uu):
        from mg_ic_code_tpu.ops import stencils as st
        u_gh = fill_ghosts(uu, geom, 1, coarse_u=coarse_u,
                           homogeneous_phys=True)
        return st.gsrb_color(
            u_gh, rhs, coefs["a"][0], coefs["b"][0], coefs["lam"][0],
            spec.alpha, spec.beta, spec.dx[0], spec.boxes[0].lo, i % 2,
        )

    ref = jax.lax.fori_loop(0, 6, body, u)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=1e-12)


def test_lp_coefs_carry_dense_bottom_inverse():
    """Mixed-precision coefficient sets must include the f32 cast of the
    dense bottom inverse, or the f32 preconditioner silently falls back
    to the launch-bound BiCGStab bottom tower (code-review r2)."""
    geom = single_level_geom(16, 1.0, BCSpec())
    cfg = poisson_cfg(alpha=1.0, precond_precision="single")
    spec = comp.make_amr_spec(geom, cfg)
    a = [jnp.asarray(RNG.uniform(0.5, 2.0, (16, 16, 16)))]
    coefs = comp.build_coefs(spec, a)
    assert coefs[0].get("binv") is not None  # 4^3 bottom box
    assert "binv" in coefs[0]["lp"]
    assert coefs[0]["lp"]["binv"].dtype == jnp.float32


def test_singular_bottom_never_densely_inverted():
    """alpha=0 with all-periodic faces is singular (constant null vector):
    the dense bottom inverse must not be built even under 'auto'."""
    geom = single_level_geom(16, 1.0, BCSpec(periodic=True))
    spec = mg.make_level_spec(geom, 0, alpha=0.0, beta=-1.0, nsmooth=4)
    coefs = mg.build_level_coefs(spec, jnp.zeros((16, 16, 16)))
    assert coefs.get("binv") is None
    # definite operator still gets it
    spec2 = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=4)
    coefs2 = mg.build_level_coefs(
        spec2, jnp.ones((16, 16, 16))
    )
    assert coefs2.get("binv") is not None


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_precond_precision_auto_resolves_by_backend(monkeypatch, platform):
    """precond_precision="auto" (the default) resolves to the f64
    preconditioner on every platform; only an explicit "single" picks the
    mixed f32 one."""
    import jax

    geom = single_level_geom(8, 1.0, BCSpec())
    cfg = poisson_cfg(alpha=1.0)  # default: auto
    assert cfg.precond_precision == "auto"
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert comp.make_amr_spec(geom, cfg).precond_dtype is None
    cfg_s = poisson_cfg(alpha=1.0, precond_precision="single")
    assert comp.make_amr_spec(geom, cfg_s).precond_dtype == "float32"
    # explicit settings are never overridden
    cfg_d = poisson_cfg(alpha=1.0, precond_precision="double")
    assert comp.make_amr_spec(geom, cfg_d).precond_dtype is None


def test_periodic_edge_face_two_level_solve_converges():
    """End-to-end consistency of the periodic wrapped-CF operator
    (round-3 review finding): a fine box TOUCHING a periodic domain face
    must solve to tolerance — with the old physical-Dirichlet fallthrough
    the Krylov operator disagreed with the smoother's CF classification
    and convergence stalls; with the wrap it is one consistent operator."""
    from mg_ic_code_tpu.grid.geometry import HierarchyGeom

    dom0 = Box.from_shape((16, 16, 16))
    fine = Box.from_shape((16, 8, 8), lo=(0, 4, 4))  # touches x faces
    geom = HierarchyGeom(
        boxes=(dom0, fine), domain_boxes=(dom0, dom0.refine(2)),
        dx=(1.0 / 16, 1.0 / 32), domain_length=(1.0, 1.0, 1.0),
        bc=BCSpec(periodic=True),
    )
    cfg = poisson_cfg(alpha=1.0, is_periodic=True)
    spec = comp.make_amr_spec(geom, cfg)
    rng = np.random.default_rng(3)
    a = [jnp.asarray(rng.uniform(0.5, 2.0, (16, 16, 16))),
         jnp.asarray(rng.uniform(0.5, 2.0, (16, 8, 8)))]
    coefs = comp.build_coefs_jit(spec, a)
    r = [jnp.asarray(rng.standard_normal((16, 16, 16))),
         jnp.asarray(rng.standard_normal((16, 8, 8)))]
    out = comp.solve_linear_jit(
        spec, coefs, r, [jnp.zeros_like(x) for x in r]
    )
    assert bool(out.converged), float(out.final_rnorm / out.initial_rnorm)
    assert int(out.iters) <= 6
    assert float(out.final_rnorm / out.initial_rnorm) < 1e-10


def test_composite_apply_cf_decomposition_matches_fill_ghosts():
    """The homogeneous composite_apply splits the operator into the
    homogeneous ghost fill + the linear coarse-ghost face term
    (cf_interp.add_cf_coarse_term) instead of the full fill_ghosts
    assembly (VERDICT r3 next #5). Both forms must agree to FLOP-reorder
    tolerance on bbox, forest, and periodic-nested geometries."""
    from mg_ic_code_tpu.grid.geometry import geom_from_config
    from mg_ic_code_tpu.ops import stencils as st
    from mg_ic_code_tpu.ops.ghosts import fill_ghosts

    def ref_apply(spec, coefs, u_list):
        geom = spec.geom
        out = []
        for l in range(spec.num_levels):
            u_gh = fill_ghosts(
                u_list[l], geom, l,
                coarse_u=u_list[geom.parent[l]] if l > 0 else None,
                homogeneous_phys=True,
            )
            c = coefs[l]
            out.append(st.apply_op(
                u_gh, c["a"][0], c["b"][0], spec.alpha, spec.beta,
                geom.dx[l],
            ))
        return out

    cases = []
    # 2-level bbox chain
    cfg = poisson_cfg(alpha=1.0, max_level=1)
    cases.append((cfg, geom_from_config(
        cfg, (Box.from_shape((16, 16, 16)),
              Box.from_shape((16, 16, 16), lo=(8, 8, 8))))))
    # forest: two sibling patches
    cfg_f = poisson_cfg(alpha=1.0, max_level=1, n_cells=(32, 32, 32))
    cases.append((cfg_f, geom_from_config(
        cfg_f,
        (Box.from_shape((32, 32, 32)),
         Box.from_shape((16, 16, 16), lo=(4, 8, 8)),
         Box.from_shape((16, 16, 16), lo=(40, 8, 8))),
        (-1, 0, 0))))
    # periodic with a non-spanning refined level touching the domain face
    # (the wrap-CF classification)
    cfg_p = poisson_cfg(alpha=1.0, max_level=1, is_periodic=True)
    cases.append((cfg_p, geom_from_config(
        cfg_p, (Box.from_shape((16, 16, 16)),
                Box.from_shape((16, 16, 16), lo=(0, 8, 8))))))

    for cfg_i, geom in cases:
        spec = comp.make_amr_spec(geom, cfg_i)
        rng = np.random.default_rng(11)
        a = [jnp.asarray(rng.uniform(0.5, 1.5, geom.shape(l)))
             for l in range(geom.num_levels)]
        # exercise the variable-bCoef face scaling too
        b = [jnp.asarray(rng.uniform(0.8, 1.2, geom.shape(l)))
             for l in range(geom.num_levels)]
        u = [jnp.asarray(rng.standard_normal(geom.shape(l)))
             for l in range(geom.num_levels)]
        for bl in (None, b):
            coefs = comp.build_coefs(spec, a, bl)
            got = comp.composite_apply(spec, coefs, u, True)
            want = ref_apply(spec, coefs, u)
            for g, w in zip(got, want):
                # face cells see the ghost term added separately instead of
                # inside the lap sum: FLOP reassociation at ~1e4 operand
                # scale => ~1e-12 absolute deviation, nothing more
                scale = float(np.max(np.abs(np.asarray(w)))) + 1.0
                np.testing.assert_allclose(
                    np.asarray(g), np.asarray(w), rtol=0,
                    atol=1e-14 * scale,
                )


def test_precond_inner_residual_matches_apply_form():
    """The precond's inner composite residual is routed through the LEVEL
    residual (mg.residual_homog) plus
    the negated CF coarse-ghost term, instead of rhs - composite_apply.
    Both forms must agree to FLOP-reorder tolerance on bbox / forest /
    periodic-nested geometries, with and without variable bCoef, in f64
    and on the f32 lp coefficient set."""
    from mg_ic_code_tpu.grid.geometry import geom_from_config

    cases = []
    cfg = poisson_cfg(alpha=1.0, max_level=1)
    cases.append((cfg, geom_from_config(
        cfg, (Box.from_shape((16, 16, 16)),
              Box.from_shape((16, 16, 16), lo=(8, 8, 8))))))
    cfg_f = poisson_cfg(alpha=1.0, max_level=1, n_cells=(32, 32, 32))
    cases.append((cfg_f, geom_from_config(
        cfg_f,
        (Box.from_shape((32, 32, 32)),
         Box.from_shape((16, 16, 16), lo=(4, 8, 8)),
         Box.from_shape((16, 16, 16), lo=(40, 8, 8))),
        (-1, 0, 0))))
    cfg_p = poisson_cfg(alpha=1.0, max_level=1, is_periodic=True)
    cases.append((cfg_p, geom_from_config(
        cfg_p, (Box.from_shape((16, 16, 16)),
                Box.from_shape((16, 16, 16), lo=(0, 8, 8))))))

    for cfg_i, geom in cases:
        for precision in ("double", "single"):
            cfg_i = dataclasses.replace(cfg_i, precond_precision=precision)
            spec = comp.make_amr_spec(geom, cfg_i)
            rng = np.random.default_rng(7)
            a = [jnp.asarray(rng.uniform(0.5, 1.5, geom.shape(l)))
                 for l in range(geom.num_levels)]
            b = [jnp.asarray(rng.uniform(0.8, 1.2, geom.shape(l)))
                 for l in range(geom.num_levels)]
            u64 = [jnp.asarray(rng.standard_normal(geom.shape(l)))
                   for l in range(geom.num_levels)]
            rhs64 = [jnp.asarray(rng.standard_normal(geom.shape(l)))
                     for l in range(geom.num_levels)]
            use_lp = precision == "single"
            dt = jnp.float32 if use_lp else jnp.float64
            u = [x.astype(dt) for x in u64]
            rhs = [x.astype(dt) for x in rhs64]
            for bl in (None, b):
                coefs = comp.build_coefs(spec, a, bl)
                got = comp._composite_residual_coefs(
                    spec, coefs, u, rhs, use_lp)
                au = comp.composite_apply(spec, coefs, u, True, use_lp)
                want = [r - x for r, x in zip(rhs, au)]
                tol = 1e-5 if use_lp else 1e-12
                for g, w in zip(got, want):
                    scale = float(np.max(np.abs(np.asarray(w)))) + 1.0
                    np.testing.assert_allclose(
                        np.asarray(g), np.asarray(w), rtol=0,
                        atol=tol * scale,
                    )
