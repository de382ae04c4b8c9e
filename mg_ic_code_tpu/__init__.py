"""mg_ic_code_tpu — geometric-multigrid initial-conditions framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
Chombo/MPI application eugenealim/MG_IC_code (binary-black-hole + scalar-field
initial data for GRChombo): it solves the Hamiltonian constraint of GR in the
conformally-flat, transverse-traceless (Bowen-York) approach,

    [alpha*aCoef(x)*I - beta*bCoef(x)*Laplacian] dpsi = rhs

re-linearised around psi in an outer Picard loop, with the linear systems
solved by BiCGStab preconditioned by AMR geometric-multigrid V-cycles with
red-black Gauss-Seidel smoothing (reference: Main_PoissonSolver.cpp:40-216).

Design stance (a re-design for accelerators, not a translation):
  * the hierarchy is a forest of LARGE dense patches (one jax.Array per
    separated tag cluster; `level_decomposition = patches`), not a union of
    small MPI boxes; sharding over the device mesh replaces rank decomposition
  * stencil kernels are fused XLA element-wise graphs, with one Pallas GPU
    kernel for the GSRB smoother, not Fortran point loops
  * halo exchange is `ppermute`/GSPMD collectives, not MPI copiers
  * global reductions are `psum`-style XLA reductions, not MPI_Allreduce
  * float64 outer arithmetic (tolerance 1e-10) with optional float32 smoothing
"""

from mg_ic_code_tpu.config import SolverConfig, ParamFile, load_params
from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec, HierarchyGeom

__version__ = "0.1.0"


def enable_x64() -> None:
    """Enable float64 in JAX (the reference is double precision throughout;

    Chombo REAL_T = double and tolerance = 1e-10 demand it for the outer
    Krylov arithmetic). Call before creating any arrays.
    """
    import jax

    jax.config.update("jax_enable_x64", True)


__all__ = [
    "Box",
    "BCSpec",
    "HierarchyGeom",
    "ParamFile",
    "SolverConfig",
    "enable_x64",
    "load_params",
]
