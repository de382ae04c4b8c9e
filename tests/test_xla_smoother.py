"""The XLA smoother, residual and restriction of solver/multigrid.py (the
production path on every level the GPU kernel does not take) against the
NumPy loop oracles of tests/reference_impl.py, over every face kind."""

import numpy as np
import jax.numpy as jnp
import pytest

from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.ops import stencils as st
from mg_ic_code_tpu.ops.ghosts import fill_ghosts_homogeneous
from mg_ic_code_tpu.solver import multigrid as mg

from reference_impl import (
    apply_op_loops, ghost_fill_loops, relax_loops, restrict_loops,
)

D, N, P, C = "dirichlet", "neumann", "periodic", "cf"

# (kinds, rho, lo): every face kind, the CF weights at the three depths a
# level's chain sees (rho = 2, 1, 1/2), and odd/even checkerboard origins
FACE_CASES = {
    "dirichlet": (((D, D),) * 3, 2.0, (0, 0, 0)),
    "neumann": (((N, N),) * 3, 2.0, (1, 0, 0)),
    "periodic": (((P, P),) * 3, 2.0, (0, 1, 1)),
    "cf_rho2": (((C, C),) * 3, 2.0, (3, 2, 2)),
    "cf_rho1": (((C, C),) * 3, 1.0, (0, 0, 1)),
    "mixed": (((P, P), (D, C), (N, C)), 0.5, (5, 4, 7)),
}

ALPHA, BETA, DX = 1.0, -1.0, 0.25


def _level(kinds, rho, lo, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    spec = mg.LevelMGSpec(
        kinds=kinds, boxes=(Box.from_shape(shape, lo=lo),), dx=(DX,),
        rho=(rho,), alpha=ALPHA, beta=BETA, nsmooth=2, smoother="xla",
    )
    a = rng.uniform(0.5, 2.0, shape).astype(dtype)
    rhs = rng.standard_normal(shape).astype(dtype)
    u = rng.standard_normal(shape).astype(dtype)
    coefs = mg.build_level_coefs(spec, jnp.asarray(a))
    return spec, coefs, a, rhs, u


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nsweeps", [1, 2])
@pytest.mark.parametrize("case", sorted(FACE_CASES))
def test_xla_relax_matches_oracle(case, nsweeps, dtype):
    kinds, rho, lo = FACE_CASES[case]
    spec, coefs, a, rhs, u = _level(kinds, rho, lo, (6, 5, 4), dtype, 3)
    lam = np.asarray(coefs["lam"][0])
    got = mg.relax_jit(spec, coefs, 0, jnp.asarray(u), jnp.asarray(rhs),
                       nsweeps)
    want = relax_loops(u, rhs, a, lam, ALPHA, BETA, DX, lo, kinds, rho,
                       nsweeps)
    tol = 1e-12 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(FACE_CASES))
def test_xla_residual_matches_oracle(case):
    kinds, rho, lo = FACE_CASES[case]
    spec, coefs, a, rhs, u = _level(kinds, rho, lo, (5, 6, 7), np.float64, 5)
    got = mg.residual_homog_jit(spec, coefs, 0, jnp.asarray(u),
                                jnp.asarray(rhs))
    want = rhs - apply_op_loops(ghost_fill_loops(u, kinds, rho), a, None,
                                ALPHA, BETA, DX)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(FACE_CASES))
def test_xla_restrict_residual_matches_oracle(case):
    kinds, rho, lo = FACE_CASES[case]
    _, _, a, rhs, u = _level(kinds, rho, lo, (4, 6, 8), np.float64, 7)
    got = st.restrict_residual(
        fill_ghosts_homogeneous(jnp.asarray(u), kinds, rho),
        jnp.asarray(rhs), jnp.asarray(a), None, ALPHA, BETA, DX,
    )
    res = rhs - apply_op_loops(ghost_fill_loops(u, kinds, rho), a, None,
                               ALPHA, BETA, DX)
    want = restrict_loops(res)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(FACE_CASES))
def test_ghost_fill_matches_oracle(case):
    """The shared homogeneous ghost rule on every face (edges and corners
    excluded: the 7-point stencil never reads them)."""
    kinds, rho, _ = FACE_CASES[case]
    u = np.random.default_rng(9).standard_normal((4, 5, 6))
    got = np.asarray(fill_ghosts_homogeneous(jnp.asarray(u), kinds, rho))
    want = ghost_fill_loops(u, kinds, rho)
    inner = (slice(1, -1),) * 3
    for ax in range(3):
        for face in (0, -1):
            sl = list(inner)
            sl[ax] = face
            np.testing.assert_allclose(got[tuple(sl)], want[tuple(sl)],
                                       rtol=1e-14, atol=1e-14)
