"""The fused GSRB sweep kernel (ops/gsrb_gpu.py) against the XLA smoother.

On the CPU the kernel runs in Pallas interpret mode (asked for here, never
by the dispatch); the `gpu` test compiles it for the card. Expected
agreement: the same arithmetic in another association order, so f64 to
~1e-14 and f32 to ~1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec, single_level_geom
from mg_ic_code_tpu.ops import dispatch, gsrb_gpu
from mg_ic_code_tpu.solver import multigrid as mg

D, N, P, C = "dirichlet", "neumann", "periodic", "cf"

FACE_CASES = {
    "dirichlet": (((D, D),) * 3, 2.0, (0, 0, 0)),
    "neumann": (((N, N),) * 3, 2.0, (1, 0, 0)),
    "periodic": (((P, P),) * 3, 2.0, (0, 1, 1)),
    "cf_rho2": (((C, C),) * 3, 2.0, (3, 2, 2)),
    "cf_rho_half": (((C, C),) * 3, 0.5, (0, 0, 1)),
    "mixed": (((P, P), (D, C), (N, C)), 1.0, (5, 4, 7)),
}
TOL = {np.float64: 1e-12, np.float32: 1e-5}
ALPHA, BETA, DX = 1.0, -1.0, 0.3


def _arrays(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.uniform(0.5, 2.0, shape).astype(dtype))
    rhs = jnp.asarray(rng.standard_normal(shape).astype(dtype))
    u = jnp.asarray(rng.standard_normal(shape).astype(dtype))
    return a, rhs, u


def _xla_relax(kinds, rho, lo, a, rhs, u, nsweeps):
    spec = mg.LevelMGSpec(
        kinds=kinds, boxes=(Box.from_shape(u.shape, lo=lo),), dx=(DX,),
        rho=(rho,), alpha=ALPHA, beta=BETA, nsmooth=nsweeps, smoother="xla",
    )
    coefs = mg.build_level_coefs(spec, a)
    return mg.relax_jit(spec, coefs, 0, u, rhs, nsweeps), coefs["lam"][0]


def _check(kinds, rho, lo, shape, dtype, nsweeps, seed=0, interpret=True,
           tile=gsrb_gpu.TILE):
    a, rhs, u = _arrays(shape, dtype, seed)
    want, lam = _xla_relax(kinds, rho, lo, a, rhs, u, nsweeps)
    got = gsrb_gpu.gsrb_relax(
        u, rhs, a, lam, kinds=kinds, rho=rho, alpha=ALPHA, beta=BETA,
        dx=DX, lo=lo, nsweeps=nsweeps, interpret=interpret, tile=tile,
    )
    assert got.shape == shape and got.dtype == dtype
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("shape", [(4, 8, 16), (5, 9, 7)],
                         ids=["pow2", "masked"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(FACE_CASES))
def test_kernel_matches_xla_relax(case, dtype, shape):
    kinds, rho, lo = FACE_CASES[case]
    _check(kinds, rho, lo, shape, dtype, nsweeps=2)


@pytest.mark.parametrize("lo", [(0, 0, 0), (0, 0, 1)], ids=["even", "odd"])
@pytest.mark.parametrize("nsweeps", [1, 2, 3, 4])
def test_kernel_sweep_counts_and_parity(nsweeps, lo):
    kinds, rho, _ = FACE_CASES["mixed"]
    _check(kinds, rho, lo, (6, 10, 12), np.float64, nsweeps, seed=nsweeps)


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 17, 33), (2, 40, 3)])
def test_kernel_edge_shapes(shape):
    """The smallest extents the ghost rule allows, and y/z extents that
    straddle a tile edge."""
    kinds, rho, lo = FACE_CASES["cf_rho2"]
    _check(kinds, rho, lo, shape, np.float64, nsweeps=2, seed=1)


@pytest.mark.parametrize("shape", [(3, 16, 16), (3, 17, 30), (2, 5, 70)])
@pytest.mark.parametrize("tile", [(16, 16), (8, 32), (4, 64), (16, 32)])
def test_kernel_tiles(tile, shape):
    """Any power-of-two tile, on extents that fill it exactly, overhang it,
    or are smaller than it."""
    kinds, rho, lo = FACE_CASES["mixed"]
    _check(kinds, rho, lo, shape, np.float64, nsweeps=1, seed=3, tile=tile)


def _kernel_via_dispatch(monkeypatch):
    """Make multigrid.relax take the kernel on this CPU: the dispatch sees
    a GPU, and the kernel runs in interpret mode."""
    calls = []
    real = gsrb_gpu.gsrb_relax

    def interpreted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, interpret=True, **kw)

    monkeypatch.setattr(dispatch, "platform", lambda: "gpu")
    monkeypatch.setattr(gsrb_gpu, "gsrb_relax", interpreted)
    return calls


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_relax_dispatches_kernel_on_gpu(monkeypatch, dtype):
    kinds, rho, lo = FACE_CASES["dirichlet"]
    a, rhs, u = _arrays((8, 8, 8), dtype, 2)
    want, _ = _xla_relax(kinds, rho, lo, a, rhs, u, 3)
    calls = _kernel_via_dispatch(monkeypatch)
    spec = mg.LevelMGSpec(
        kinds=kinds, boxes=(Box.from_shape(u.shape, lo=lo),), dx=(DX,),
        rho=(rho,), alpha=ALPHA, beta=BETA, nsmooth=3,
    )
    coefs = mg.build_level_coefs(spec, a)
    got = mg.relax(spec, coefs, 0, u, rhs, 3)
    assert calls == [(8, 8, 8)]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("bc", [BCSpec(), BCSpec(periodic=True)],
                         ids=["dirichlet", "periodic"])
def test_vcycle_with_kernel_matches_xla(monkeypatch, bc):
    """A whole V-cycle down to the 2^3 bottom depth with every depth's
    smoother on the kernel equals the all-XLA V-cycle."""
    n = 16
    geom = single_level_geom(n, 1.0, bc)
    spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=2,
                              min_size=2)
    a, rhs, u = _arrays((n, n, n), np.float64, 4)
    coefs = mg.build_level_coefs(spec, a)
    want = mg.mg_vcycle(spec, coefs, u, rhs)
    calls = _kernel_via_dispatch(monkeypatch)
    got = jax.jit(mg.mg_vcycle, static_argnums=(0,))(spec, coefs, u, rhs)
    assert {s[0] for s in calls} >= {16, 8, 4}, calls
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-11, atol=1e-11)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_kernel_compiled_for_gpu_matches_xla(gpu_device, dtype):
    kinds, rho, lo = FACE_CASES["mixed"]
    with jax.default_device(gpu_device):
        _check(kinds, rho, lo, (33, 40, 72), dtype, nsweeps=4,
               interpret=False)
