"""The routing layer, the compile-cache helper, the row-blocked Gram
matvec of the GPU route (``ops/gram.xla_gram_matvec``) on the heat
``H k H*`` closed form, and the error-free transforms of ``ops/ff.py``.

The tests marked ``gpu`` check the routed matvecs as compiled for the
card; ``chip_smoke.py`` phase 1 checks the same at N=1e5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import linpde_gp_tpu as lgt
from linpde_gp_tpu import backend
from linpde_gp_tpu.ops import diffops, ff
from linpde_gp_tpu.ops.gram import (
    gram_matvec,
    kernel_term_specs,
    make_banded_matvec,
    terms_gram,
    xla_gram_matvec,
)
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel


def _heat_terms():
    k = 1.0 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
        lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    k_hh = apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, k, argnum=1), argnum=0
    )
    return kernel_term_specs(k_hh)[1]


def _points(rng, n):
    return np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1)


# -- the GPU route: row-blocked plain XLA -----------------------------------


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("r", [1, 20])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_xla_matvec_row_blocked_matches_dense(dtype, r, compensated):
    """Ragged row blocks (n0 not a block multiple), one and several
    right-hand sides, float32/float64, plain and compensated — against
    the float64 dense product on the same (rounded) points, relative to
    max (|K| |v|)."""
    terms = _heat_terms()
    rng = np.random.default_rng(11)
    n0, n1 = 70, 93
    X0 = _points(rng, n0).astype(dtype)
    X1 = _points(rng, n1).astype(dtype)
    V = rng.standard_normal((n1, r)).astype(dtype)
    v = V[:, 0] if r == 1 else V
    out = xla_gram_matvec(
        terms, X0, X1, v, compensated=compensated, block_entries=16 * n1
    )
    assert out.shape == v.shape[:0] + (n0,) + v.shape[1:]
    assert out.dtype == dtype
    out = np.asarray(out, np.float64).reshape(n0, r)
    X0d, X1d = X0.astype(np.float64), X1.astype(np.float64)
    G = np.asarray(terms_gram(terms, X0d, X1d))
    V64 = V.astype(np.float64)
    err = np.max(np.abs(out - G @ V64)) / np.max(np.abs(G) @ np.abs(V64))
    # float32: the contraction accumulates in float32 either way.
    assert err < (1e-13 if dtype == np.float64 else 1e-6)


# -- plain XLA reductions -----------------------------------------------------


@pytest.mark.parametrize("r", [1, 3])
def test_xla_matvec_row_blocks_match_single_block(r):
    terms = _heat_terms()
    rng = np.random.default_rng(13)
    X0, X1 = _points(rng, 101), _points(rng, 64)
    V = rng.standard_normal((64, r))
    one = xla_gram_matvec(terms, X0, X1, V)
    blocked = xla_gram_matvec(terms, X0, X1, V, block_entries=64 * 16)  # ragged
    np.testing.assert_allclose(np.asarray(blocked), np.asarray(one), rtol=0, atol=1e-12)
    dense = np.asarray(terms_gram(terms, X0, X1)) @ V
    np.testing.assert_allclose(np.asarray(one), dense, rtol=0, atol=1e-11)


def test_banded_matvec_tile_arguments():
    """Band granularity is an argument: any tile shape gives the same
    exact product, finer tiles a narrower band fraction."""
    k = 1.5 * lgt.kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.05)
    spec = kernel_term_specs(k)
    rng = np.random.default_rng(14)
    X = rng.uniform(0.0, 1.0, 600)
    v = rng.standard_normal(600)
    dense = np.asarray(k.matrix(jnp.asarray(X))) @ v
    coarse = make_banded_matvec(spec, X, X, tile0=300, tile1=200)
    fine = make_banded_matvec(spec, X, X, tile0=32, tile1=64)
    for mv in (coarse, fine):
        np.testing.assert_allclose(np.asarray(mv(v)), dense, rtol=0, atol=1e-12)
    assert fine.band_tiles / fine.total_tiles < coarse.band_tiles / coarse.total_tiles


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize(
    "platform, op, kw, want",
    [
        ("gpu", "matvec", dict(n0=10, n1=10), "xla"),
        ("gpu", "matvec", dict(n0=10**5, n1=10**5), "xla"),
        ("gpu", "matvec", dict(terms=False), "xla"),
        ("gpu", "gram", dict(n0=10**5, n1=4096), "xla"),
        ("gpu", "matvec", dict(compact=True), "banded"),
        ("cpu", "matvec", dict(n0=4096, n1=4096), "native"),
        ("cpu", "gram", dict(n0=4096, n1=4096), "native"),
        ("cpu", "matvec", dict(n0=100, n1=100), "xla"),
        ("cpu", "matvec", dict(n0=4096, n1=4096, terms=False), "xla"),
        ("cpu", "matvec", dict(n0=4096, n1=4096, compact=True), "banded"),
    ],
)
def test_route(platform, op, kw, want):
    assert backend.route(op, platform_name=platform, **kw) == want


def test_route_native_threshold_and_switch():
    n = int(np.sqrt(lgt.config.native_gram_threshold))
    assert backend.route("matvec", platform_name="cpu", n0=n, n1=n) == "native"
    assert backend.route("matvec", platform_name="cpu", n0=n - 1, n1=n) == "xla"
    prev = lgt.config.use_native_host_engine
    lgt.config.set(use_native_host_engine=False)
    try:
        assert backend.route("matvec", platform_name="cpu", n0=n, n1=n) == "xla"
    finally:
        lgt.config.set(use_native_host_engine=prev)


@pytest.mark.parametrize("name", ["rocm", "METAL", "opencl"])
def test_unsupported_platform_raises(name):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.route("matvec", platform_name=name)


def test_route_rejects_unknown_reduction():
    with pytest.raises(ValueError):
        backend.route("solve", platform_name="cpu")


# -- compile cache --------------------------------------------------------------


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_repo_local(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(lgt.__file__)))
    assert backend.compile_cache_dir() == os.path.join(root, ".jax_cache")


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache(monkeypatch, tmp_path, env_set):
    """With the variable set the helper sets no directory of its own;
    without it the directory is the fixed repo-local one."""
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs",
    )
    saved = {k: getattr(jax.config, k) for k in keys}
    sentinel = str(tmp_path / "already")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            assert backend.enable_compile_cache() == str(tmp_path / "env")
            assert jax.config.jax_compilation_cache_dir == sentinel
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = backend.enable_compile_cache()
            assert path == backend.compile_cache_dir()
            assert jax.config.jax_compilation_cache_dir == path
            assert os.path.isdir(path)
        assert jax.config.jax_persistent_cache_min_entry_size_bytes == -1
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


# -- error-free transforms under fused multiply-add ----------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_split_is_exact_and_host_constants_agree(dtype):
    rng = np.random.default_rng(15)
    a = (rng.standard_normal(1000) * 10.0 ** rng.integers(-5, 5, 1000)).astype(dtype)
    hi, lo = ff._split(jnp.asarray(a), dtype)
    hi, lo = np.asarray(hi), np.asarray(lo)
    np.testing.assert_array_equal(hi + lo, a)
    h0, l0 = ff._split(float(a[3]), dtype)
    assert (h0, l0) == (hi[3], lo[3])


def test_two_prod_float32_is_error_free():
    rng = np.random.default_rng(16)
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    p, e = ff.two_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


# -- on the card ------------------------------------------------------------------

# Error relative to max (|K| |v|): float64 round-off; the float32 entries'
# evaluation error; compensated entries summed by a float32 reduction.
_GPU_BOUNDS = {"f64": 1e-10, "f32": 1e-4, "f32c": 1e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 16])
@pytest.mark.parametrize(
    "name, dtype, compensated",
    [("f64", np.float64, False), ("f32", np.float32, False), ("f32c", np.float32, True)],
)
def test_gpu_routed_matvec_matches_float64(name, dtype, compensated, r):
    terms = _heat_terms()
    rng = np.random.default_rng(17)
    n = 8192
    X = _points(rng, n).astype(dtype)
    V = rng.standard_normal((n, r)).astype(dtype)
    v = V[:, 0] if r == 1 else V
    assert backend.route("matvec", n0=n, n1=n) == "xla"
    fn = jax.jit(lambda a, w: gram_matvec((1.0, terms), a, a, w, compensated=compensated))
    out = np.asarray(fn(jnp.asarray(X), jnp.asarray(v)), np.float64).reshape(n, r)
    G = np.asarray(terms_gram(terms, jnp.asarray(X, jnp.float64), jnp.asarray(X, jnp.float64)))
    V64 = V.astype(np.float64)
    err = np.max(np.abs(out - G @ V64)) / np.max(np.abs(G) @ np.abs(V64))
    assert err <= _GPU_BOUNDS[name]


@pytest.mark.gpu
def test_gpu_banded_matvec_matches_dense():
    k = 1.5 * lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.02)
    spec = kernel_term_specs(k)
    rng = np.random.default_rng(18)
    X = rng.uniform(0.0, 1.0, 8192)
    v = rng.standard_normal(8192)
    mv = make_banded_matvec(spec, X, X)
    assert mv.band_tiles < mv.total_tiles
    G = np.asarray(k.matrix(jnp.asarray(X)))
    err = np.max(np.abs(np.asarray(jax.jit(mv)(v)) - G @ v)) / np.max(np.abs(G) @ np.abs(v))
    assert err <= 1e-10
