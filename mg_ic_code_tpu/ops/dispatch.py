"""The one place that decides what each platform runs.

Everything else in the package is plain JAX and runs the same on every
backend; only the GSRB smoother has a hand-written GPU kernel
(ops/gsrb_gpu.py). This module decides, per level, whether it is used.
Interpret mode is never chosen here: tests ask for it explicitly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def use_gsrb_kernel(smoother: str, platform: str, dtype, shape,
                    has_b: bool, sharded: bool) -> bool:
    """Whether n GSRB sweeps on a level run the fused GPU kernel: on a GPU,
    in f32 or f64, for constant bCoef, outside a device mesh (`sharded`:
    sharded levels run the explicit-halo XLA smoother of parallel/halo.py,
    and replicated levels of a meshed solve the XLA body), on a level
    whose every extent has the two cells the ghost rule reads."""
    return (
        smoother == "auto"
        and platform == "gpu"
        and jnp.dtype(dtype) in (jnp.float32, jnp.float64)
        and not has_b
        and not sharded
        and min(shape) >= 2
    )


def platform() -> str:
    """The default backend's platform name ("gpu", "cpu")."""
    return jax.default_backend()
