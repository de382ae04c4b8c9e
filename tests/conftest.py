"""Test harness config: CPU backend with 8 virtual devices, float64.

The multi-device sharding tests run on a virtual 8-device CPU mesh.
Must run before jax is imported anywhere. Tests that need an NVIDIA GPU
are marked `gpu` and take the `gpu_device` fixture, which skips them
where JAX finds none.
"""

import os
import sys

# CPU unless the caller names a platform (`JAX_PLATFORMS=cuda,cpu pytest
# -m gpu` runs the GPU tests on the card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

assert len(jax.devices("cpu")) == 8, jax.devices("cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX sees none (decided here, at run
    time, never while a test module is imported)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu)")
    return devs[0]


# Persistent compile cache: ONLY for the fresh-interpreter flagship
# subprocesses (MG_FLAGSHIP_INNER), where the giant solver graphs repeat
# across runs and serialization is reliable. The LONG-LIVED outer suite
# process must not touch the cache at all: XLA:CPU's executable
# serialize/deserialize aborts/segfaults reproducibly late in a
# many-hundred-module process — first observed on giant writes (round
# 2-4, name-gated), then on a fast-compiling module's write, then on a
# SMALL entry's read (round 5) — the crash tracks process history, not
# any particular entry, so no per-entry gate is safe.
_cache = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      ".jax_cache")
if os.environ.get("MG_FLAGSHIP_INNER") == "1":
    jax.config.update("jax_compilation_cache_dir", _cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Do NOT persist (or load) the GIANT solver-graph executables from the
# test process: late in a full suite run (hundreds of jitted modules on
# the heap) XLA:CPU's executable export/import segfaults reproducibly on
# the multi-hundred-KB entries — `executable.serialize()` of the 7-level
# flagship fused-iteration graph at the cache-write step, and
# `deserialize_executable` of a problem_fields entry at the read step —
# while the same tests standalone (fresh process) serialize fine, and
# every entry on disk zstd-decompresses cleanly (so it is not file
# corruption). The put side gates by MODULE NAME ("_fused_iteration" —
# the only family observed to crash serialize); the get side gates by
# entry size: the p95 entry is 304 KB and the 19 entries above 300 KB
# are exactly the monster solve graphs whose keys are
# process-history-specific anyway (module-name counters), so suite runs
# never hit foreign entries — skipping them costs one recompile and
# removes the crash. The get guard reads each hit twice (its own
# cache.get plus the one inside _orig_get) — accepted: the public API
# offers no way to pass bytes through, and suite cache hits are small.
# Scripts/recorders (fresh processes, ~/.cache dir) still cache
# everything.
from jax._src import compilation_cache as _cc  # noqa: E402

_MAX_ENTRY = 300_000  # compressed bytes

_orig_put = _cc.put_executable_and_time
_orig_get = _cc.get_executable_and_time


def _guarded_put(cache_key, module_name, executable, backend, compile_time):
    # Round-5 widening, twice: the segfault first hit a giant
    # non-"_fused_iteration" module (compile-time gate added), then a
    # SMALL interpret-mode kernel executable at the same process-history
    # point — the crash is a function of how much the process has
    # compiled, not of any one module. The only robust rule: the
    # LONG-LIVED suite process never writes the persistent cache at all.
    # Reads still hit entries written by fresh processes (the isolated
    # flagship subprocesses carry MG_FLAGSHIP_INNER and still write, as
    # do scripts/recorders), which is where caching actually pays.
    if os.environ.get("MG_FLAGSHIP_INNER") == "1":
        if "_fused_iteration" in module_name:
            return None  # the one family that crashes even standalone
        return _orig_put(cache_key, module_name, executable, backend,
                         compile_time)
    return None


def _guarded_get(cache_key, compile_options, backend, executable_devices):
    cache = _cc._get_cache(backend)
    if cache is not None:
        raw = cache.get(cache_key)
        if raw is not None and len(raw) > _MAX_ENTRY:
            return None, None
    return _orig_get(cache_key, compile_options, backend,
                     executable_devices)


_cc.put_executable_and_time = _guarded_put
_cc.get_executable_and_time = _guarded_get
