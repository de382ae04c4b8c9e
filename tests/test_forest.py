"""Multi-patch (forest) hierarchy tests.

The hierarchy is a forest of dense patches (HierarchyGeom.parent): two
well-separated refined regions become sibling entries at the same depth —
the dense-array answer to Chombo's disjoint Berger-Rigoutsos clusters
(SetGrids.cpp:108-126) without union-of-boxes bookkeeping or same-level
exchange (siblings are separated by construction).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mg_ic_code_tpu.config import SolverConfig
from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec, HierarchyGeom
from mg_ic_code_tpu.solver import composite as comp
from mg_ic_code_tpu.solver import reductions as red

RNG = np.random.default_rng(11)


def two_patch_geom(n=32, L=1.0, depth2=False):
    """Base n^3, two sibling patches at depth 1 separated in x; optionally
    one grandchild nested in the first patch."""
    assert n % 8 == 0
    dom0 = Box.from_shape((n, n, n))
    # depth-1 index space is 2n; siblings separated in x by n/2 cells
    a = Box((n // 4, 5 * n // 8, 5 * n // 8),
            (3 * n // 4 - 1, 11 * n // 8 - 1, 11 * n // 8 - 1))
    b = Box((5 * n // 4, 5 * n // 8, 5 * n // 8),
            (7 * n // 4 - 1, 11 * n // 8 - 1, 11 * n // 8 - 1))
    boxes = [dom0, a, b]
    parent = [-1, 0, 0]
    if depth2:
        # inside a.refine(2) with nesting radius >= 2
        boxes.append(Box((5 * n // 8, 11 * n // 8, 11 * n // 8),
                         (11 * n // 8 - 1, 21 * n // 8 - 1, 21 * n // 8 - 1)))
        parent.append(1)
    nl = len(boxes)
    dxs = [L / n, L / (2 * n), L / (2 * n), L / (4 * n)][:nl]
    doms = [dom0, dom0.refine(2), dom0.refine(2), dom0.refine(4)][:nl]
    return HierarchyGeom(
        boxes=tuple(boxes), domain_boxes=tuple(doms), dx=tuple(dxs),
        domain_length=(L, L, L), bc=BCSpec(), parent=tuple(parent),
    )


def forest_cfg(**kw):
    base = dict(
        alpha=1.0, beta=-1.0, max_level=1, n_cells=(32, 32, 32), L=1.0,
        num_mg_smooth=4, num_mg_iterations=2, max_iterations=60,
        tolerance=1e-11, is_periodic=False,
    )
    base.update(kw)
    return SolverConfig(**base)


def test_forest_geom_invariants():
    g = two_patch_geom(depth2=True)
    assert g.parent == (-1, 0, 0, 1)
    assert g.children(0) == (1, 2)
    assert g.children(1) == (3,)
    assert g.depth_of(3) == 2
    assert g.entries_at_depth(1) == (1, 2)
    assert g.max_depth == 2
    # child_slices are disjoint regions of the parent array
    s1 = g.child_slices(0, 1)
    s2 = g.child_slices(0, 2)
    assert s1[0].stop <= s2[0].start or s2[0].stop <= s1[0].start


def test_forest_sibling_separation_enforced():
    n = 32
    dom0 = Box.from_shape((n, n, n))
    a = Box((8, 20, 20), (23, 43, 43))
    touching = Box((24, 20, 20), (39, 43, 43))  # grown rings intersect
    with pytest.raises(ValueError, match="separated"):
        HierarchyGeom(
            boxes=(dom0, a, touching),
            domain_boxes=(dom0, dom0.refine(2), dom0.refine(2)),
            dx=(1.0 / n, 0.5 / n, 0.5 / n),
            domain_length=(1.0, 1.0, 1.0), bc=BCSpec(),
            parent=(-1, 0, 0),
        )


def _u_exact(geom, l):
    x, y, z = geom.coords(l)
    return (
        np.sin(np.pi * (x + 0.5))
        * np.sin(np.pi * (y + 0.5))
        * np.sin(np.pi * (z + 0.5))
    )


def _solve_analytic(geom, n, max_level):
    cfg = forest_cfg(alpha=0.0, max_level=max_level, n_cells=(n, n, n))
    spec = comp.make_amr_spec(geom, cfg)
    coefs = comp.build_coefs_jit(
        spec, [jnp.zeros(geom.shape(l)) for l in range(geom.num_levels)]
    )
    rhs = [jnp.asarray(-3.0 * np.pi**2 * _u_exact(geom, l))
           for l in range(geom.num_levels)]
    out = comp.solve_linear_jit(
        spec, coefs, rhs, [jnp.zeros_like(r) for r in rhs]
    )
    assert bool(out.converged), float(out.final_rnorm)
    masked = red.mask_covered(
        [x - jnp.asarray(_u_exact(geom, l)) for l, x in enumerate(out.x)],
        geom,
    )
    return max(float(jnp.max(jnp.abs(m))) for m in masked)


def test_forest_analytic_solution_matches_chain_accuracy():
    """+Lap(u) = rhs with homogeneous Dirichlet on a 3-deep forest (two
    siblings + one grandchild): the solve must converge and match the
    analytic product-of-sines solution on every patch's valid region with
    the SAME accuracy class as the chain (dense-bbox) hierarchy. (The
    composite discretisation itself is not fully 2nd order at CF
    boundaries: reflux is disabled for reference parity —
    VariableCoeffPoissonOperator.cpp:264-271 — and covered coarse cells
    are not averaged down, so both designs share the same CF-dominated
    error; the forest must not make it worse.) Also checks the error
    still shrinks with resolution."""
    errs_forest, errs_chain = [], []
    for n in (16, 32):
        geom = two_patch_geom(n=n, depth2=True)
        errs_forest.append(_solve_analytic(geom, n, 2))
        # chain: one depth-1 bbox covering both sibling patches
        a, b = geom.boxes[1], geom.boxes[2]
        bbox = Box(
            tuple(min(x, y) for x, y in zip(a.lo, b.lo)),
            tuple(max(x, y) for x, y in zip(a.hi, b.hi)),
        )
        dom0 = Box.from_shape((n, n, n))
        chain = HierarchyGeom(
            boxes=(dom0, bbox), domain_boxes=(dom0, dom0.refine(2)),
            dx=(1.0 / n, 0.5 / n), domain_length=(1.0, 1.0, 1.0),
            bc=BCSpec(),
        )
        errs_chain.append(_solve_analytic(chain, n, 1))
    for ef, ec in zip(errs_forest, errs_chain):
        assert ef < 2.5 * ec, (errs_forest, errs_chain)
    assert errs_forest[1] < 0.75 * errs_forest[0], errs_forest


def test_forest_vcycle_contracts():
    geom = two_patch_geom()
    cfg = forest_cfg()
    spec = comp.make_amr_spec(geom, cfg)
    a = [jnp.asarray(RNG.uniform(0.5, 2.0, geom.shape(l)))
         for l in range(geom.num_levels)]
    coefs = comp.build_coefs_jit(spec, a)
    rhs = [jnp.asarray(RNG.standard_normal(geom.shape(l)))
           for l in range(geom.num_levels)]
    u = [jnp.zeros_like(r) for r in rhs]
    r0 = float(red.composite_max_norm(
        comp.composite_residual_jit(spec, coefs, u, rhs, True), geom))
    for _ in range(3):
        e = comp.amr_vcycle_jit(
            spec, coefs,
            comp.composite_residual_jit(spec, coefs, u, rhs, True))
        u = [a_ + b_ for a_, b_ in zip(u, e)]
    r3 = float(red.composite_max_norm(
        comp.composite_residual_jit(spec, coefs, u, rhs, True), geom))
    # ~0.13-0.16/cycle matches the chain hierarchy
    assert r3 < 5e-3 * r0, (r0, r3)


def test_patches_mode_bbh_end_to_end():
    """level_decomposition = patches on a separated-puncture BBH config:
    tagging must produce sibling patches (one per puncture), the full
    nonlinear solve must converge, and the trajectory must agree with
    bbox mode to leading order (the discretisations differ only in how
    much tag-free area is refined)."""
    import dataclasses
    from mg_ic_code_tpu.grid import tagging
    from mg_ic_code_tpu.solver.nonlinear import poisson_solve

    cfg = SolverConfig(
        alpha=1.0, beta=-1.0, L=64.0, n_cells=(64, 16, 16), max_level=1,
        num_mg_smooth=4, num_mg_iterations=2, max_iterations=40,
        max_nl_iterations=3, tolerance=1e-10,
        refine_threshold=0.25, block_factor=4, max_grid_size=8,
        bh1_bare_mass=0.5, bh2_bare_mass=0.5,
        bh1_offset=24.0, bh2_offset=-24.0,
        bh1_spin=0.0, bh2_spin=0.0, bh1_momentum=0.02, bh2_momentum=-0.02,
        phi_amplitude=0.0, phi_wavelength=1.0,
        level_decomposition="patches",
    )
    geom = tagging.generate_hierarchy(cfg)
    assert geom.num_levels == 3, [geom.boxes[e] for e in range(geom.num_levels)]
    assert geom.children(0) == (1, 2)
    dense = sum(geom.boxes[e].num_cells for e in (1, 2))
    bbox_cfg = dataclasses.replace(cfg, level_decomposition="bbox")
    bgeom = tagging.generate_hierarchy(bbox_cfg)
    assert bgeom.num_levels == 2
    assert dense < 0.5 * bgeom.boxes[1].num_cells  # the point of patches

    r_pat = poisson_solve(cfg, verbose=False)
    r_bbox = poisson_solve(bbox_cfg, verbose=False)
    assert min(r_pat.dpsi_norm_history) < cfg.tolerance
    assert r_pat.dpsi_norm_history[0] == pytest.approx(
        r_bbox.dpsi_norm_history[0], rel=0.02
    )


def test_forest_masked_reductions():
    geom = two_patch_geom()
    ones = [jnp.ones(geom.shape(l)) for l in range(geom.num_levels)]
    s = float(red.composite_sum(ones, geom))
    # integral of 1 over the domain: covered coarse cells excluded, fine
    # cells counted at fine volume — total must equal the domain volume
    # over the region covered at least once = just the domain volume
    assert s == pytest.approx(1.0, rel=1e-12)


def test_forest_sharded_solve_matches_serial():
    """Patches-mode hierarchy sharded over the 8-device mesh (GSPMD +
    explicit shard_map smoother wherever an entry's x extent shards) must
    reproduce the replicated composite solve."""
    from mg_ic_code_tpu.parallel import mesh as pmesh

    geom = two_patch_geom(n=32)
    cfg = forest_cfg()
    spec = comp.make_amr_spec(geom, cfg)
    a = [jnp.asarray(RNG.uniform(0.5, 2.0, geom.shape(l)))
         for l in range(geom.num_levels)]
    rhs = [jnp.asarray(RNG.standard_normal(geom.shape(l)))
           for l in range(geom.num_levels)]
    coefs = comp.build_coefs_jit(spec, a)
    ref = comp.solve_linear_jit(
        spec, coefs, rhs, [jnp.zeros_like(r) for r in rhs])

    m = pmesh.make_mesh()
    spec_s = comp.make_amr_spec(geom, cfg, m)
    a_s = pmesh.shard_level_list(a, geom, m)
    rhs_s = pmesh.shard_level_list(rhs, geom, m)
    x0_s = pmesh.shard_level_list(
        [jnp.zeros_like(r) for r in rhs], geom, m)
    coefs_s = comp.build_coefs_jit(spec_s, a_s)
    out = comp.solve_linear_jit(spec_s, coefs_s, rhs_s, x0_s)

    assert bool(out.converged)
    for xr, xs in zip(ref.x, out.x):
        np.testing.assert_allclose(np.asarray(xs), np.asarray(xr),
                                   rtol=1e-9, atol=1e-11)


def test_merge_until_separated_invariant_fuzz():
    """The cap-merge loop must re-establish sibling separation after every
    union (a union can engulf or abut a third candidate): all outputs
    must be pairwise >= 2 cells apart within a parent (code-review r2)."""
    from mg_ic_code_tpu.grid.tagging import _merge_until_separated

    rng = np.random.default_rng(0)
    allowed = {0: Box((0, 0, 0), (199, 199, 199))}
    for trial in range(300):
        cands = []
        for _ in range(rng.integers(2, 9)):
            lo = rng.integers(0, 180, size=3)
            hi = lo + rng.integers(1, 20, size=3)
            cands.append((Box(tuple(int(x) for x in lo),
                              tuple(int(min(x, 199)) for x in hi)), 0))
        out = _merge_until_separated(list(cands), allowed,
                                     cap=int(rng.integers(1, 4)))
        for i in range(len(out)):
            for j in range(i + 1, len(out)):
                assert out[i][0].grow(1).intersect(out[j][0]) is None, (
                    trial, out[i][0], out[j][0])


def test_forest_average_down():
    """finish_iteration's average-down must restrict each child patch into
    its own parent region (disjoint per sibling)."""
    from mg_ic_code_tpu.solver.nonlinear import finish_iteration
    from mg_ic_code_tpu.ops import stencils as st

    geom = two_patch_geom(depth2=True)
    psi = [jnp.asarray(RNG.standard_normal(geom.shape(e)))
           for e in range(geom.num_levels)]
    zeros = [jnp.zeros_like(p) for p in psi]
    out, _ = finish_iteration(geom, psi, zeros, average_down=True)
    # grandchild (entry 3) restricts into patch 1 first, then both
    # siblings restrict into the base
    p1 = psi[1].at[geom.child_slices(1, 3)].set(st.restrict_full(psi[3]))
    np.testing.assert_allclose(np.asarray(out[1]), np.asarray(p1))
    base = psi[0]
    base = base.at[geom.child_slices(0, 1)].set(st.restrict_full(p1))
    base = base.at[geom.child_slices(0, 2)].set(st.restrict_full(psi[2]))
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(base))


def test_forest_batched_vcycle_matches_sequential():
    """forest_batching=force: sibling patches run as ONE vmapped sweep —
    must be bitwise-identical to the sequential per-entry V-cycle (same
    GSRB math, same order within each patch)."""
    geom = two_patch_geom(n=32, depth2=True)
    cfg_seq = forest_cfg(forest_batching="off")
    cfg_bat = forest_cfg(forest_batching="force")
    spec_seq = comp.make_amr_spec(geom, cfg_seq)
    spec_bat = comp.make_amr_spec(geom, cfg_bat)
    assert spec_seq.batch_groups == ()
    assert spec_bat.batch_groups == ((1, 2),), spec_bat.batch_groups

    a = [jnp.asarray(RNG.uniform(0.5, 2.0, geom.shape(l)))
         for l in range(geom.num_levels)]
    r = [jnp.asarray(RNG.standard_normal(geom.shape(l)))
         for l in range(geom.num_levels)]
    coefs = comp.build_coefs_jit(spec_seq, a)

    e_seq = comp.amr_vcycle_jit(spec_seq, coefs, r)
    e_bat = comp.amr_vcycle_jit(spec_bat, coefs, r)
    for s, b in zip(e_seq, e_bat):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(s))


def test_forest_batched_solve_on_2d_mesh_matches_serial():
    """Patches mode on a (4, 2) pencil mesh: unshardable sibling patches
    batch with the patch axis sharded over the y mesh axis (auto policy) —
    LoadBalance-style concurrency — and the solve matches serial."""
    import jax
    from mg_ic_code_tpu.parallel import mesh as pmesh
    from mg_ic_code_tpu.solver import multigrid as mg

    geom = two_patch_geom(n=16)
    cfg = forest_cfg(n_cells=(16, 16, 16))
    m2 = pmesh.make_mesh(shape=(4, 2))
    spec_s = comp.make_amr_spec(geom, cfg, m2)
    # (8, 12, 12) sibling patches cannot slab-shard at MIN_LOCAL_NX=8
    # (8/4 = 2, 12/2 = 6) -> the auto policy batches them instead of
    # letting every device recompute both, replicated
    assert mg._shard_counts(spec_s.level_specs[1], 0) == (1, 1, 1)
    assert spec_s.batch_groups == ((1, 2),), spec_s.batch_groups
    # the stacked patch axis lands on the y mesh axis: 2 patches / 2
    # y-groups -> each 4-device column owns ONE patch (concurrent, not
    # replicated-sequential)
    assert pmesh.patch_axis(m2, 2) == pmesh.AXIS_Y

    # sharding inspection of the actual stacked batch
    def stacked(arrs):
        return comp._stack_patches(arrs, m2)

    out = jax.jit(stacked)([
        jnp.zeros(geom.shape(1)), jnp.zeros(geom.shape(2))
    ])
    assert "y" in str(out.sharding.spec), out.sharding

    spec = comp.make_amr_spec(geom, cfg)
    a = [jnp.asarray(RNG.uniform(0.5, 2.0, geom.shape(l)))
         for l in range(geom.num_levels)]
    rhs = [jnp.asarray(RNG.standard_normal(geom.shape(l)))
           for l in range(geom.num_levels)]
    coefs = comp.build_coefs_jit(spec, a)
    ref = comp.solve_linear_jit(
        spec, coefs, rhs, [jnp.zeros_like(x) for x in rhs])

    a_s = pmesh.shard_level_list(a, geom, m2)
    rhs_s = pmesh.shard_level_list(rhs, geom, m2)
    x0_s = pmesh.shard_level_list([jnp.zeros_like(x) for x in rhs], geom, m2)
    coefs_s = comp.build_coefs_jit(spec_s, a_s)
    out = comp.solve_linear_jit(spec_s, coefs_s, rhs_s, x0_s)
    assert bool(out.converged)
    for xr, xs in zip(ref.x, out.x):
        np.testing.assert_allclose(np.asarray(xs), np.asarray(xr),
                                   rtol=1e-9, atol=1e-11)
