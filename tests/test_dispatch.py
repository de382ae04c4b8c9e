"""ops/dispatch: which smoother each level gets; the config keys and the
compile-cache location that go with them."""

import itertools
import os

import jax
import jax.numpy as jnp
import pytest

from mg_ic_code_tpu.config import load_params
from mg_ic_code_tpu.grid.geometry import BCSpec, single_level_geom
from mg_ic_code_tpu.ops import dispatch, gsrb_gpu
from mg_ic_code_tpu.parallel import mesh as pmesh
from mg_ic_code_tpu.solver import multigrid as mg
from mg_ic_code_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "smoother,platform,dtype,has_b,sharded",
    list(itertools.product(
        ["auto", "xla"], ["gpu", "cpu"],
        [jnp.float64, jnp.float32, jnp.bfloat16],
        [False, True], [False, True],
    )),
)
def test_kernel_choice_table(smoother, platform, dtype, has_b, sharded):
    """The kernel runs exactly on an unsharded constant-b level, in f32 or
    f64, on a GPU, unless the config asks for the XLA body."""
    want = (smoother == "auto" and platform == "gpu"
            and dtype in (jnp.float64, jnp.float32)
            and not has_b and not sharded)
    assert dispatch.use_gsrb_kernel(smoother, platform, dtype, (8, 8, 8),
                                    has_b, sharded) is want


@pytest.mark.parametrize("shape,want", [
    ((2, 2, 2), True), ((1, 8, 8), False), ((8, 1, 8), False),
    ((8, 8, 1), False), ((960, 144, 144), True),
])
def test_kernel_choice_by_shape(shape, want):
    assert dispatch.use_gsrb_kernel("auto", "gpu", jnp.float64, shape,
                                    False, False) is want


def test_platform_is_the_default_backend():
    assert dispatch.platform() == jax.default_backend() == "cpu"


@pytest.mark.parametrize("n", [64, 8], ids=["sharded", "replicated"])
@pytest.mark.parametrize("mesh_shape", [(8,), (4, 2)], ids=["slab", "pencil"])
def test_meshed_level_never_takes_kernel(monkeypatch, mesh_shape, n):
    """Under a device mesh relax runs XLA even where the dispatch sees a
    GPU: the explicit-halo smoother on sharded levels, the XLA body on
    levels too small to shard."""
    monkeypatch.setattr(dispatch, "platform", lambda: "gpu")

    def boom(*a, **k):
        raise AssertionError("kernel called on a sharded level")

    monkeypatch.setattr(gsrb_gpu, "gsrb_relax", boom)
    geom = single_level_geom(n, 1.0, BCSpec())
    m = pmesh.make_mesh(shape=mesh_shape)
    spec = mg.make_level_spec(geom, 0, alpha=1.0, beta=-1.0, nsmooth=1,
                              mesh=m, with_depths=False)
    assert (mg._shard_counts(spec, 0) != (1, 1, 1)) == (n == 64)
    a = jnp.ones((n, n, n))
    coefs = mg.build_level_coefs(spec, a)
    u = mg.relax(spec, coefs, 0, jnp.zeros((n, n, n)), jnp.ones((n, n, n)),
                 1)
    assert u.shape == (n, n, n)


@pytest.mark.parametrize("value,ok", [
    ("auto", True), ("xla", True), ("pallas", False),
])
def test_smoother_key(tmp_path, value, ok):
    p = tmp_path / "params.txt"
    p.write_text(open(os.path.join(REPO, "configs", "params.txt")).read())
    if ok:
        assert load_params(str(p), [f"smoother = {value}"]).smoother == value
    else:
        with pytest.raises(ValueError, match="smoother"):
            load_params(str(p), [f"smoother = {value}"])


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_configure(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert compile_cache.configure() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert os.path.isdir(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
