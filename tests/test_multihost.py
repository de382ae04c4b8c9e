"""Two-process jax.distributed simulation (VERDICT r1 next-step #5).

The reference runs 24 MPI ranks with parallel HDF5 (jobscript.pbs:3,15);
here two CPU processes under jax.distributed (gloo collectives) prove the
multi-host bootstrap (`distributed.initialize`), the collective
gather-then-coordinator-write I/O path, and the per-process pout.<n>
streams (Chombo parstream, Main_PoissonSolver.cpp:261-291).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_bootstrap_and_io(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, f"worker {i} did not finish:\n{out}"

    # per-process pout.<n> streams (parstream role); process 0 mirrors to
    # stdout
    for i in range(2):
        txt = (tmp_path / f"pout.{i}").read_text()
        assert f"process {i}/2 up" in txt
        assert "writes done" in txt
    assert "process 0/2 up" in outs[0] + outs[1]

    # the coordinator alone wrote both files; gathered data is the full
    # global array (values chosen per level in the worker)
    from mg_ic_code_tpu.io import chombo_hdf5 as io

    plot = tmp_path / "vcPoissonOut.3d_0.hdf5"
    final = tmp_path / "vcPoissonFinal.3d.hdf5"
    assert plot.exists() and final.exists()
    # level 0: one box; level 1: the forest's TWO sibling patches, each
    # with its own gathered data (entry index e = 1, 2)
    box, _, _, named = io.read_level_data(str(plot), 0)
    assert box.shape == (8, 8, 8)
    np.testing.assert_allclose(named["dpsi"], 0.5, rtol=0)
    boxes, _, _, patches = io.read_level_patches(str(plot), 1)
    assert len(boxes) == 2 and all(b.shape == (4, 8, 8) for b in boxes)
    for e, named in zip((1, 2), patches):
        np.testing.assert_allclose(named["dpsi"], 0.5 + e, rtol=0)
        np.testing.assert_allclose(named["rhs"], 2.0 + e, rtol=0)
        np.testing.assert_allclose(named["psi"], 1.0 + 0.01 * e, rtol=0)
    _, _, _, fnamed = io.read_level_data(str(final), 0)
    assert set(fnamed) >= {"chi", "K", "lapse", "phi"}
    assert np.all(fnamed["chi"] > 0)


def test_two_process_full_solve_matches_single(tmp_path):
    """A REAL multi-process solve (VERDICT r4 missing #1): the canonical
    3-level BBH config (params.txt physics, 32^3 base for CI runtime)
    runs end-to-end through the multi-host code path —
    distributed.initialize -> main.run -> host-major mesh -> sharded
    poisson_solve with cross-process collectives -> coordinator-only
    HDF5 during the solve — under 2 processes x 2 virtual CPU devices,
    and its Picard dpsi-norm history matches a single-process run of the
    same driver to f64 reorder tolerance."""
    import json
    import re

    port = _free_port()
    env = dict(os.environ)
    # single-split codegen: XLA:CPU's parallel codegen splits modules
    # nondeterministically, and two processes running differently-split
    # copies of the same SPMD program mismatch their collective order in
    # gloo (observed as preamble-size aborts and silent hangs); with one
    # split the schedule is deterministic and the 2-process solve is
    # stable (3/3 trials)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                        "--xla_cpu_parallel_codegen_split_count=1")
    # a fresh compile cache of this test's own
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jax_cache")

    def hist_of(outs):
        for out in outs:
            m = re.search(r"HIST (\[.*?\])", out)
            if m:
                return json.loads(m.group(1))
        raise AssertionError(f"no HIST line in worker output:\n{outs[0][-3000:]}")

    # serial reference: same driver, one process (its own directory)
    serial_dir = tmp_path / "serial"
    serial_dir.mkdir()
    p = subprocess.Popen(
        [sys.executable, WORKER, "0", "0", str(serial_dir), "solve1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
    )
    out_serial = p.communicate(timeout=1200)[0]
    assert p.returncode == 0, f"serial worker failed:\n{out_serial[-3000:]}"
    h_serial = hist_of([out_serial])
    assert len(h_serial) == 3 and h_serial[-1] < h_serial[0]

    # the 2-process solve
    multi_dir = tmp_path / "multi"
    multi_dir.mkdir()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(port), str(multi_dir),
             "solve"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {i}" in out
    h_multi = hist_of(outs)

    # equality with the serial history: both solves are f64 end-to-end
    # on CPU, so only collective/reduction reorder separates them — tight
    # on the first step, looser on the later ones (each Picard step
    # re-linearises, amplifying the reorder noise as dpsi approaches the
    # floor; measured rel deviation 1e-13 / 2e-10 / 5e-7 across steps)
    np.testing.assert_allclose(h_multi[0], h_serial[0], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(h_multi), np.asarray(h_serial),
                               rtol=1e-3)
    # the coordinator alone wrote the solve's plotfiles + checkpoint
    assert (multi_dir / "vcPoissonFinal.3d.hdf5").exists()
    assert (multi_dir / "vcPoissonOut.3d_0.hdf5").exists()
    assert (multi_dir / "pout.0").exists() and (multi_dir / "pout.1").exists()
