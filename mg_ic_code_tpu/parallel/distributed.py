"""Multi-host bootstrap and host-aware mesh construction.

Equivalent of the reference's MPI_Init/MPI_Finalize process bootstrap
(Main_PoissonSolver.cpp:261-263, 289-291): `initialize()` wraps
jax.distributed.initialize so that N processes (one per host) present all
their GPUs in jax.devices(); `host_mesh()` then builds the device mesh with
the host dimension outermost, so that neighbouring x-shards sit on the same
host wherever they can.

On a single process everything degrades to no-ops, so the same driver code
runs on one card and on N hosts unchanged.
"""

from __future__ import annotations

import jax

from mg_ic_code_tpu.parallel import mesh as pmesh


def initialize(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """Bring up the multi-process runtime (idempotent). Every process gets
    the same `coordinator_address` (host:port of process 0) and
    `num_processes`, and its own `process_id`: nothing is auto-detected."""
    # NOTE: do not probe jax.process_count() here — it initialises the XLA
    # backend, after which jax.distributed.initialize refuses to run
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "only be called once" in str(e):
            return  # already initialised: idempotent no-op
        raise


def choose_mesh_shape(
    n_cells: tuple[int, int, int], ndev: int
) -> tuple[int, ...]:
    """Mesh topology for a base grid of `n_cells` on `ndev` devices:
    prefer 1-D x slabs (one exchange axis, least communication); go to an
    (x, y) pencil when x alone cannot give every device a useful slab
    (>= MIN_LOCAL_NX rows, evenly dividing — the same usefulness rule
    parallel.mesh.level_spec shards by). Among feasible pencils pick the
    most slab-like (largest sx): the x-slab path exchanges whole
    contiguous planes.

    The chooser never emits a z mesh axis: z is the contiguous axis of
    every level array, so its halo planes are strided gathers, and an
    (x, y) pencil of equal device count moves no more halo data than an
    (x, z) one on these grids. z-sharding remains reachable by
    constructing a 3-D mesh manually (parallel.mesh.make_mesh), and the
    halo paths still handle it correctly. Locked by
    tests/test_parallel.py::test_choose_mesh_shape_never_shards_z."""
    nx, ny = n_cells[0], n_cells[1]

    def ok(n, s):
        return s == 1 or (n % s == 0 and n // s >= pmesh.MIN_LOCAL_NX)

    if ok(nx, ndev):
        return (ndev,)
    for sx in range(ndev - 1, 0, -1):
        if ndev % sx:
            continue
        sy = ndev // sx
        if ok(nx, sx) and ok(ny, sy):
            return (sx, sy)
    return (ndev,)  # nothing divides usefully: level_spec will replicate


def host_mesh(n_cells: tuple[int, int, int] | None = None):
    """Device mesh ordered host-major: consecutive mesh coordinates land on
    the same host, so only the outermost seams of the slab/pencil halo
    exchanges cross hosts (the reference's analogue is jobscript.pbs
    handing rank placement to the scheduler). With `n_cells`, the
    1-D-vs-pencil topology is chosen by choose_mesh_shape."""
    devs = sorted(
        jax.devices(), key=lambda d: (d.process_index, d.id)
    )
    n = len(devs)
    shape = (n,) if n_cells is None else choose_mesh_shape(n_cells, n)
    return pmesh.make_mesh(devs, shape)


def is_coordinator() -> bool:
    return jax.process_index() == 0


def gather_global(x):
    """Full global value of a (possibly multi-host-sharded) array as host
    numpy — the role MPI gathers play before the reference's rank-0 HDF5
    writes (WriteOutput.H routes everything through Chombo's parallel
    writers; jobscript.pbs runs 24 ranks).

    COLLECTIVE when the array is not fully addressable: every process must
    call it (process_allgather runs an all-gather over the global mesh).
    Single-process and host-local arrays take the trivial path.
    """
    import numpy as np

    if isinstance(x, np.ndarray):
        return x
    if not isinstance(x, jax.Array):
        return np.asarray(x)
    if x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def stream_global_slabs(x, axis: int = 0, max_bytes: int = 1 << 25):
    """Yield (start, host-numpy block) tiles of a (possibly
    multi-host-sharded) array along `axis`, gathering at most ~max_bytes
    per tile — the streamed replacement for a full-level gather_global in
    the HDF5 writers (at 512^3+ multi-host, materialising whole levels
    on host 0 is the memory and network bottleneck; the
    reference writes through parallel HDF5, WriteOutput.H:107-113).

    COLLECTIVE when the array is not fully addressable: every process
    must drain the FULL generator in the same order (each tile is a
    process_allgather). Addressable arrays yield one host-local tile."""
    import numpy as np

    if isinstance(x, np.ndarray):
        yield 0, x
        return
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        yield 0, np.asarray(x)
        return
    from jax.experimental import multihost_utils

    n = x.shape[axis]
    row_bytes = (x.size // max(n, 1)) * x.dtype.itemsize
    rows = max(1, min(n, max_bytes // max(row_bytes, 1)))
    for a in range(0, n, rows):
        b = min(n, a + rows)
        sl = tuple(
            slice(a, b) if d == axis else slice(None) for d in range(x.ndim)
        )
        yield a, np.asarray(
            multihost_utils.process_allgather(x[sl], tiled=True)
        )
