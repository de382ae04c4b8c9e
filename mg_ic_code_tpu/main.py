"""CLI driver: `python -m mg_ic_code_tpu.main <params_file> [key=value ...]`.

Mirrors the reference binary's contract (Main_PoissonSolver.cpp:259-293):
argv[1] is a ParmParse-format parameter file, later arguments override keys.
Reads params, builds the tagged AMR hierarchy, runs the nonlinear solve, and
writes the per-iteration plotfiles plus the GRChombo-restart checkpoint.
Exit status 0 on success, 2 on non-convergence (the reference propagates the
solver exit status and MayDays on ||dpsi|| > 0.1).

Where the reference calls MPI_Init, a multi-host launch calls
parallel.distributed.initialize before run(); on one host every visible
device joins the mesh.
"""

from __future__ import annotations

import sys

import jax


def run(argv: list[str]) -> int:
    if len(argv) < 2:
        print(f" usage {argv[0]} <input_file_name> ", file=sys.stderr)
        return 0

    jax.config.update("jax_enable_x64", True)
    from mg_ic_code_tpu.utils import compile_cache

    compile_cache.configure()

    from mg_ic_code_tpu.config import load_params
    from mg_ic_code_tpu.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu.io import chombo_hdf5 as io
    from mg_ic_code_tpu.solver.nonlinear import (
        NonConvergenceError, poisson_solve,
    )

    cfg = load_params(argv[1], overrides=argv[2:])
    if cfg.write_output and not io.HAVE_H5PY:
        # the outputs are HDF5: fail before the solve, not after it
        print(" h5py is not installed: install it, or set write_output = 0 "
              "to solve without writing plotfiles and the checkpoint",
              file=sys.stderr)
        return 2
    from mg_ic_code_tpu.io.logging import pout, set_verbosity

    set_verbosity(cfg.verbosity)
    pout(f"alpha, beta = {cfg.alpha}, {cfg.beta}")
    pout(f"periodicity = {int(cfg.is_periodic)}")

    initial_psi = None
    if cfg.read_from_checkpoint:
        # warm start: rebuild the recorded hierarchy and seed psi from the
        # checkpoint instead of tagging grids from scratch (the read-in
        # loop SetGrids.cpp:29-30 mentions but the reference never built)
        from mg_ic_code_tpu.io import restart

        geom, initial_psi, _ = restart.load_state(
            cfg.read_from_checkpoint, cfg
        )
        pout(f"warm start from {cfg.read_from_checkpoint} "
             f"({geom.num_levels} levels)")
    else:
        geom = generate_hierarchy(cfg)
    pout(
        "grids: "
        + ", ".join(
            f"level {d}: "
            + " + ".join(
                str(geom.boxes[e].shape) for e in geom.entries_at_depth(d)
            )
            + f" @ dx={geom.dx[geom.entries_at_depth(d)[0]]:.6g}"
            for d in range(geom.max_depth + 1)
        )
    )

    def snapshot(nl_iter, state):
        # per-iteration plotfile, like output_solver_data
        from mg_ic_code_tpu.solver.nonlinear import prepare_iteration_jit

        _, rhs_list, _ = prepare_iteration_jit(
            geom, cfg, state["fields"], state["psi"]
        )
        io.write_solver_data(
            f"vcPoissonOut.3d_{nl_iter}.hdf5", geom, cfg,
            state["dpsi"], rhs_list, state["psi"], state["fields"], nl_iter,
        )

    # several devices: shard the level arrays over all of them (the MPI
    # rank decomposition role). The mesh is host-major
    # (distributed.host_mesh), and its 1-D-vs-pencil topology is picked
    # from the base-grid extents (choose_mesh_shape).
    mesh = None
    if len(jax.devices()) > 1:
        from mg_ic_code_tpu.parallel import distributed as dist

        mesh = dist.host_mesh(cfg.n_cells)
        pout(
            f"sharding over {len(jax.devices())} devices "
            f"(host-major mesh, shape {dict(mesh.shape)})"
        )

    try:
        res = poisson_solve(cfg, geom=geom, mesh=mesh,
                            output_hook=snapshot if cfg.write_output else None,
                            initial_psi=initial_psi)
    except NonConvergenceError as e:
        print(str(e), file=sys.stderr)
        return 2

    if not cfg.write_output:
        pout("write_output = 0: no checkpoint written")
        return 0
    io.write_final_data(
        "vcPoissonFinal.3d.hdf5", geom, cfg, res.psi, res.fields,
        res.constant_K,
    )
    pout("wrote vcPoissonFinal.3d.hdf5")
    return 0


def cli() -> None:
    """console_scripts entry point."""
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    sys.exit(run(sys.argv))
