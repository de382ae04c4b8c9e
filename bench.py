"""Headline benchmark: GSRB smoother throughput at 256^3 on one GPU.

Usage: python bench.py [N] [mode]   (mode: f32 | f64 | sharded)

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...evidence}

`value` is the MARGINAL smoother rate: the slope between a 16-sweep and a
40-sweep relax call (each chained inside one jit), which cancels any fixed
per-call cost; the slope is measured over interleaved hi/lo trial pairs
(median of per-pair slopes), so clock drift hits both points of a pair
alike. The raw 40-sweep headline stays in evidence as `headline_dof_s`.

`vs_baseline` is the fraction of the HBM bytes bound: the bytes the
production dispatch must move per sweep, computed from the shape (the
fused GPU kernel reads u, rhs, aCoef, lambda and writes u once per sweep;
the XLA body does so per colour), over the device's peak bandwidth.

Every mode runs the production dispatch (`smoother = auto`). A device
missing from HBM_BYTES_PER_S is an error, and so is a run without a GPU:
there is no fallback. Every JSON line names the platform, device kind,
device count and the card's power limit.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

from mg_ic_code_tpu.grid.geometry import BCSpec, single_level_geom  # noqa: E402
from mg_ic_code_tpu.ops import dispatch  # noqa: E402
from mg_ic_code_tpu.solver import multigrid as mg  # noqa: E402

# peak HBM bandwidth (bytes/s) by jax device_kind — NVIDIA data sheet
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
}

SWEEPS = 40       # headline sweep count per timed call
SWEEPS_LO = 16    # second point for the marginal-rate fit


def device_bandwidth() -> float:
    kind = jax.devices()[0].device_kind
    if kind not in HBM_BYTES_PER_S:
        raise KeyError(f"no peak bandwidth on record for {kind!r}")
    return HBM_BYTES_PER_S[kind]


def device_record() -> dict:
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


def streams_per_sweep(spec, dtype, shape, sharded=False) -> int:
    """Arrays the smoother moves through HBM per sweep at this level (a
    level of a meshed solve is `sharded`): the fused kernel reads u, rhs,
    aCoef, lambda and writes u once; the XLA body does the same for each
    colour."""
    kernel = dispatch.use_gsrb_kernel(spec.smoother, dispatch.platform(),
                                      dtype, shape, False, sharded)
    return 5 if kernel else 10


def barrier(x):
    jax.block_until_ready(x)
    return float(jnp.sum(x))


def run_sharded(n: int, sweeps: int):
    """Multi-device halo-exchange smoother throughput (all local devices,
    1-D slab mesh): the production sharded smoother — `multigrid.relax`
    with spec.mesh set, which runs the explicit-halo XLA body
    (halo.sharded_relax) on every sharded level. Returns (dof_per_s,
    bytes-bound fraction aggregated over devices)."""
    import time as _time

    from mg_ic_code_tpu.parallel import mesh as pmesh

    dtype = jnp.float32
    geom = single_level_geom(n, 1.0, BCSpec())
    m = pmesh.make_mesh()
    ndev = m.shape[pmesh.AXIS]
    spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=sweeps,
                              mesh=m)
    sx = mg._shard_counts(spec, 0)[0]
    sh = pmesh.level_sharding(geom, 0, m)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    a = jax.device_put(jax.random.uniform(k1, (n, n, n), dtype, 0.5, 2.0), sh)
    coefs = mg.build_level_coefs_jit(spec, a)
    rhs = jax.device_put(jax.random.normal(k2, (n, n, n), dtype), sh)
    u = jax.device_put(jnp.zeros((n, n, n), dtype), sh)
    u = mg.relax_jit(spec, coefs, 0, u, rhs, sweeps)
    barrier(u)
    t0 = _time.perf_counter()
    reps = 3
    for _ in range(reps):
        u = mg.relax_jit(spec, coefs, 0, u, rhs, sweeps)
    barrier(u)
    dt = (_time.perf_counter() - t0) / reps
    cells = float(n) ** 3
    dof_per_s = cells * sweeps / dt
    streams = streams_per_sweep(spec, dtype, (n, n, n), sharded=True)
    bw = streams * cells * jnp.dtype(dtype).itemsize * sweeps / dt
    frac = bw / (device_bandwidth() * ndev)
    print(f"sharded over {ndev} device(s) (explicit x-shards {sx}, f32 "
          f"production dispatch): {dof_per_s:.3e} DOF/s, "
          f"{frac:.2%} of the aggregate bytes bound", file=sys.stderr)
    return dof_per_s, frac


def setup_mode(n: int, mode: str):
    dtype = {"f32": jnp.float32, "f64": jnp.float64}[mode]
    geom = single_level_geom(n, 1.0, BCSpec())
    spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=4)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.uniform(k1, (n, n, n), dtype, 0.5, 2.0)
    coefs = mg.build_level_coefs_jit(spec, a)
    rhs = jax.random.normal(k2, (n, n, n), dtype)
    u = jnp.zeros_like(rhs)
    return spec, coefs, rhs, u, dtype


def make_chained(spec, coefs, rhs, u, sweeps: int, reps: int = 3):
    """A jitted callable running `reps` n-sweep relax calls CHAINED INSIDE
    ONE JIT — the production shape: the solver runs the smoother inside a
    jitted solve, never as a bare host dispatch. The chained calls are
    sequentially data-dependent, so XLA cannot elide any of them."""

    @jax.jit
    def chained(x):
        for _ in range(reps):
            x = mg.relax(spec, coefs, 0, x, rhs, sweeps)
        return x

    barrier(chained(u))  # compile
    return lambda: barrier(chained(u)), reps


def time_interleaved(run_hi, run_lo, trials: int = 5):
    """Time hi/lo sweep-count calls in back-to-back pairs, `trials` times.
    Returns (dt_hi_list, dt_lo_list) of per-call seconds, pair-ordered: a
    drift episode hits both members of a pair alike, so the per-pair
    slope (dt_hi - dt_lo) is drift-robust where either absolute time is
    not."""
    fn_hi, reps_hi = run_hi
    fn_lo, reps_lo = run_lo
    hi, lo = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn_hi()
        hi.append((time.perf_counter() - t0) / reps_hi)
        t0 = time.perf_counter()
        fn_lo()
        lo.append((time.perf_counter() - t0) / reps_lo)
    return hi, lo


def median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    mode = sys.argv[2] if len(sys.argv) > 2 else "f32"

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform}")
    record = device_record()
    print(f"device: {record}, mode: {mode}", file=sys.stderr)

    if mode == "sharded":
        dof_per_s, frac = run_sharded(n, 16)
        print(json.dumps({
            "metric": f"sharded production GSRB smoother DOF-updates/s at "
                      f"{n}^3 f32 over {len(jax.devices())} devices",
            "value": dof_per_s,
            "unit": "DOF-updates/s",
            "vs_baseline": frac,
            **record,
        }))
        return

    spec, coefs, rhs, u, dtype = setup_mode(n, mode)
    run_hi = make_chained(spec, coefs, rhs, u, SWEEPS)
    run_lo = make_chained(spec, coefs, rhs, u, SWEEPS_LO)
    hi_ts, lo_ts = time_interleaved(run_hi, run_lo)

    cells = float(n) ** 3
    slopes = [
        (h - l) / (SWEEPS - SWEEPS_LO) for h, l in zip(hi_ts, lo_ts)
    ]
    marg = median(slopes)
    marginal_dof_s = cells / marg if marg > 0 else float("inf")
    dt_hi = median(hi_ts)
    headline_dof_s = cells * SWEEPS / dt_hi
    streams = streams_per_sweep(spec, dtype, (n, n, n))
    bytes_per_sweep = streams * cells * jnp.dtype(dtype).itemsize
    frac = bytes_per_sweep / marg / device_bandwidth() if marg > 0 else 0.0
    overhead_ms = max(dt_hi - marg * SWEEPS, 0.0) * 1e3

    # one V-cycle wall time for context (solve-path canary)
    v = mg.mg_vcycle_jit(spec, coefs, jnp.zeros_like(rhs), rhs)
    barrier(v)
    t0 = time.perf_counter()
    v = mg.mg_vcycle_jit(spec, coefs, v, rhs)
    barrier(v)
    vcycle_s = time.perf_counter() - t0

    print(
        f"smoother marginal: {marginal_dof_s:.3e} DOF-updates/s "
        f"({frac:.2%} of the {streams}-stream bytes bound; pair slopes "
        f"{['%.4f' % (s * 1e3) for s in sorted(slopes)]} ms/sweep); raw "
        f"40-sweep headline {headline_dof_s:.3e} DOF/s, fixed cost "
        f"~{overhead_ms:.3f} ms/call; V-cycle({n}^3): {vcycle_s * 1e3:.3f} ms",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": (
            f"GSRB smoother marginal DOF-updates/s at {n}^3 ({mode}, "
            "production dispatch): slope between 16- and 40-sweep calls, "
            "median over interleaved pairs. vs_baseline = fraction of the "
            "HBM bytes bound for the streams the dispatched smoother moves"
        ),
        "value": marginal_dof_s,
        "unit": "DOF-updates/s",
        "vs_baseline": frac,
        "streams_per_sweep": streams,
        "headline_dof_s": headline_dof_s,
        "pair_slopes_ms_per_sweep": [s * 1e3 for s in slopes],
        "sweeps": SWEEPS,
        "fixed_cost_ms": overhead_ms,
        "vcycle_ms": vcycle_s * 1e3,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        **record,
    }))


if __name__ == "__main__":
    main()
