"""End-to-end CLI driver tests (VERDICT r1 weak #7 / next-step #8).

Exercises main.run's argv contract against the reference binary's
(Main_PoissonSolver.cpp:259-293): params file + key=value overrides, one
plotfile per NL iteration (output_solver_data), the final GRChombo
checkpoint (output_final_data), exit code 0 on success and 2 on
non-convergence (the reference propagates solver exit status / MayDays).
"""

import textwrap

import numpy as np
import pytest

from mg_ic_code_tpu import main as cli
from mg_ic_code_tpu.io import chombo_hdf5

TINY_BBH = textwrap.dedent(
    """
    alpha = 1.0
    beta  = -1.0
    L = 16.0
    N = 16 16 16
    max_level = 1
    refine_threshold = 0.1
    block_factor = 4
    max_grid_size = 16
    fill_ratio   = 0.5
    buffer_size  = 2
    numMGsmooth = 4
    numMGIterations = 1
    max_iterations = 20
    max_NL_iterations = 2
    tolerance  = 1.0e-10
    hang       = 1.0e-11
    verbosity = 0
    coefficient_average_type = harmonic
    is_periodic = 0
    bc_lo       = 0 0 0
    bc_hi       = 0 0 0
    bc_value = 0.0
    G_Newton = 1.0
    phi_amplitude = 0.05
    phi_wavelength = 1
    bh1_bare_mass = 0.2
    bh1_spin = 0.02
    bh1_momentum = 0.02
    bh1_offset = 2.0
    bh2_bare_mass = 0.2
    bh2_spin = 0.02
    bh2_momentum = -0.02
    bh2_offset = -2.0
    """
)


@pytest.fixture()
def tiny_params(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the driver writes HDF5 into CWD
    p = tmp_path / "params.txt"
    p.write_text(TINY_BBH)
    return str(p)


def test_cli_end_to_end(tiny_params, tmp_path):
    rc = cli.run(["main", tiny_params])
    assert rc == 0

    # one plotfile per NL iteration (output_solver_data role)
    plots = sorted(tmp_path.glob("vcPoissonOut.3d_*.hdf5"))
    assert [p.name for p in plots] == [
        "vcPoissonOut.3d_0.hdf5", "vcPoissonOut.3d_1.hdf5",
    ]
    box, dom, dx, named = chombo_hdf5.read_level_data(str(plots[0]), 0)
    assert box.shape == (16, 16, 16)
    assert set(named) >= {"dpsi", "rhs", "psi"}
    # iteration-0 snapshot is taken before the first linear solve: dpsi = 0
    assert float(np.abs(named["dpsi"]).max()) == 0.0
    assert float(np.abs(named["rhs"]).max()) > 0.0

    # final GRChombo checkpoint with the 29-var state
    final = tmp_path / "vcPoissonFinal.3d.hdf5"
    assert final.exists()
    fbox, _, _, fnamed = chombo_hdf5.read_level_data(str(final), 0)
    assert fbox.shape == (16, 16, 16)
    chi = fnamed["chi"]
    assert chi.min() > 0.0  # chi = psi^-4 must stay positive
    assert set(fnamed) >= {"chi", "K", "lapse", "A11", "phi"}


def test_cli_override_and_nonconvergence_exit_2(tiny_params):
    # a single Picard iteration on a strong-field configuration leaves
    # ||dpsi|| > 0.1 -> the reference MayDays (exit 2)
    rc = cli.run([
        "main", tiny_params,
        "max_NL_iterations = 1",
        "phi_amplitude = 1.0",
    ])
    assert rc == 2


def test_cli_usage_no_args(capsys):
    rc = cli.run(["main"])
    assert rc == 0
    assert "usage" in capsys.readouterr().err


def test_cli_patches_mode_end_to_end(tmp_path, monkeypatch):
    """CLI with level_decomposition=patches on a separated-puncture config:
    exit 0, plotfiles + checkpoint written, and the refined level stored
    as a multi-box Chombo level."""
    import textwrap as _tw

    monkeypatch.chdir(tmp_path)
    p = tmp_path / "params.txt"
    p.write_text(_tw.dedent(
        """
        alpha = 1.0
        beta  = -1.0
        L = 64.0
        N = 64 16 16
        max_level = 1
        refine_threshold = 0.25
        block_factor = 4
        max_grid_size = 8
        fill_ratio = 0.5
        buffer_size = 2
        numMGsmooth = 4
        num_mg = 1
        numMGIterations = 2
        max_iterations = 40
        max_NL_iterations = 2
        tolerance = 1.0e-10
        hang = 1.0e-11
        verbosity = 1
        coefficient_average_type = harmonic
        is_periodic = 0
        bc_lo = 0 0 0
        bc_hi = 0 0 0
        bc_value = 0.0
        G_Newton = 1.0
        phi_amplitude = 0.0
        phi_wavelength = 1
        bh1_bare_mass = 0.5
        bh1_spin = 0.0
        bh1_momentum = 0.02
        bh1_offset = 24.0
        bh2_bare_mass = 0.5
        bh2_spin = 0.0
        bh2_momentum = -0.02
        bh2_offset = -24.0
        level_decomposition = patches
        """
    ))
    rc = cli.run(["main", str(p)])
    assert rc == 0
    final = tmp_path / "vcPoissonFinal.3d.hdf5"
    assert final.exists()
    boxes, _, _, patches = chombo_hdf5.read_level_patches(str(final), 1)
    assert len(boxes) == 2, boxes
    for named in patches:
        assert float(named["chi"].min()) > 0.0


def test_cli_restart_warm_start(tiny_params, tmp_path, capsys):
    """read_from_checkpoint wires io.restart into the product surface
    (VERDICT r4 #6): a cold solve writes vcPoissonFinal, and a warm
    re-solve seeded from it starts essentially converged — its first
    Picard step norm is orders of magnitude below the cold run's, and it
    reaches the tolerance in fewer iterations."""
    import re

    def norms(captured):
        return [float(m) for m in re.findall(
            r"norm of dpsi after step \d+ is ([0-9.eE+-]+)", captured)]

    rc = cli.run(["main", tiny_params, "max_NL_iterations = 4",
                  "verbosity = 3"])
    assert rc == 0
    cold = norms(capsys.readouterr().out)
    assert len(cold) >= 2 and cold[0] > 1e-3

    rc = cli.run(["main", tiny_params, "max_NL_iterations = 4",
                  "verbosity = 3",
                  "read_from_checkpoint = vcPoissonFinal.3d.hdf5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "warm start" in out
    warm = norms(out)
    # the warm start resumes at the cold run's converged state: its first
    # correction is already below the cold run's SECOND step, and the
    # tolerance is reached in fewer Picard iterations
    assert warm[0] < cold[1]
    assert len(warm) < len(cold)


def test_cli_write_output_off(tiny_params, tmp_path):
    """write_output = 0 runs the solve and writes no HDF5 file."""
    rc = cli.run(["main", tiny_params, "write_output = 0"])
    assert rc == 0
    assert not list(tmp_path.glob("*.hdf5"))


def test_cli_without_h5py_fails_before_the_solve(tiny_params, monkeypatch,
                                                 capsys):
    """Without h5py the driver stops before any solve unless output is
    off (it must not solve for hours and then fail to write)."""
    import mg_ic_code_tpu.solver.nonlinear as nl

    monkeypatch.setattr(chombo_hdf5, "HAVE_H5PY", False)

    def no_solve(*a, **k):
        raise AssertionError("solve started without h5py")

    monkeypatch.setattr(nl, "poisson_solve", no_solve)
    assert cli.run(["main", tiny_params]) == 2
    assert "h5py" in capsys.readouterr().err
