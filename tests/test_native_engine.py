"""Native C++/OpenMP host engine (KeOps equivalent) vs the XLA oracle.

Mirrors the reference's KeOps-vs-dense equivalence toggle test
(reference ``tests/.../test_diffops.py:58-74`` with ``_use_keops=False``):
the JIT-compiled C++ reduction must match broadcast XLA evaluation of the
same closed-form kernel to float64 round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import linpde_gp_tpu as lgt
from linpde_gp_tpu import native
from linpde_gp_tpu.config import config
from linpde_gp_tpu.ops import diffops
from linpde_gp_tpu.ops.gram import gram_matrix, gram_matvec, kernel_term_specs
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no host C++ toolchain"
)


def _heat_kernel():
    prior = 1.7 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
        lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    return apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, prior, argnum=1), argnum=0
    )


@pytest.mark.parametrize(
    "kernel,dim",
    [
        (lgt.kernels.ExpQuad((), lengthscales=0.8), 1),
        (lgt.kernels.ExpQuad((3,), lengthscales=1.3), 3),
        (_heat_kernel(), 2),
    ],
    ids=["expquad1d", "matern3d", "heat_LkL"],
)
def test_native_gram_matches_xla(kernel, dim):
    eng = native.engine_for(kernel)
    assert eng is not None
    rng = np.random.default_rng(0)
    X0 = rng.uniform(-1.0, 1.0, (37, dim)).squeeze()
    X1 = rng.uniform(-1.0, 1.0, (23, dim)).squeeze()
    shape = (-1,) + kernel.input_shape
    expected = np.asarray(gram_matrix(kernel, X0.reshape(shape), X1.reshape(shape)))
    got = eng.gram(X0, X1)
    np.testing.assert_allclose(got, expected, rtol=1e-13, atol=1e-13)


def test_native_matvec_matches_gram():
    kernel = _heat_kernel()
    eng = native.engine_for(kernel)
    rng = np.random.default_rng(1)
    X0 = rng.uniform(0.0, 1.0, (19, 2))
    X1 = rng.uniform(0.0, 1.0, (31, 2))
    v = rng.standard_normal(31)
    V = rng.standard_normal((31, 4))
    G = eng.gram(X0, X1)
    np.testing.assert_allclose(eng.matvec(X0, X1, v), G @ v, rtol=1e-12)
    np.testing.assert_allclose(eng.matvec(X0, X1, V), G @ V, rtol=1e-12)


def test_gram_matrix_routes_to_native_under_jit():
    """gram_matrix must route large CPU Grams through the native engine
    (via pure_callback) and agree with broadcast evaluation — under jit."""
    kernel = _heat_kernel()
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.uniform(0.0, 1.0, (64, 2)))
    old = config.native_gram_threshold
    try:
        config.set(native_gram_threshold=1)
        routed = jax.jit(lambda x: gram_matrix(kernel, x))(X)
    finally:
        config.set(native_gram_threshold=old)
    dense = kernel.matrix(X, X)
    np.testing.assert_allclose(np.asarray(routed), np.asarray(dense), rtol=1e-12, atol=1e-13)


def test_gram_matvec_router_native_path():
    kernel = _heat_kernel()
    spec = kernel_term_specs(kernel)
    assert spec is not None
    rng = np.random.default_rng(3)
    X = rng.uniform(0.0, 1.0, (48, 2))
    v = rng.standard_normal(48)
    old = config.native_gram_threshold
    try:
        # The size threshold gates the native matvec exactly like Gram
        # assembly; drop it so this small problem exercises the engine.
        config.set(native_gram_threshold=1)
        got = np.asarray(gram_matvec(spec, X, X, v))
    finally:
        config.set(native_gram_threshold=old)
    expected = np.asarray(kernel.matrix(jnp.asarray(X), jnp.asarray(X))) @ v
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-13)
