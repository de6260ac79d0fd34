"""Structured-linalg unit tests (reference test pattern §4.4:
``linops/test_block.py``, ``test_symmetric_block.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linpde_gp_tpu.ops.linalg import (
    Block,
    BlockDiagonal,
    Covariance,
    Dense,
    Diagonal,
    Kronecker,
    cho_solve,
    chol_extend,
    cholesky,
    solve_triangular,
)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def test_cholesky_solve(rng):
    K = random_spd(rng, 12)
    chol = cholesky(jnp.asarray(K))
    b = rng.standard_normal(12)
    x = cho_solve(chol, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(K @ x), b, atol=1e-9)


def test_chol_extend_matches_direct(rng):
    n, m = 10, 4
    K = random_spd(rng, n + m)
    A, B, D = K[:n, :n], K[:n, n:], K[n:, n:]
    chol_A = cholesky(jnp.asarray(A))
    ext = chol_extend(chol_A, jnp.asarray(B), jnp.asarray(D))
    direct = cholesky(jnp.asarray(K))
    np.testing.assert_allclose(np.asarray(ext), np.asarray(direct), atol=1e-9)
    # Solves agree with a dense solve.
    b = rng.standard_normal(n + m)
    x = cho_solve(ext, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(K @ x), b, atol=1e-8)


def test_triangular_solve_trans(rng):
    K = random_spd(rng, 8)
    chol = cholesky(jnp.asarray(K))
    b = rng.standard_normal((8, 3))
    y = solve_triangular(chol, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(chol) @ np.asarray(y), b, atol=1e-10)
    z = solve_triangular(chol, jnp.asarray(b), trans=True)
    np.testing.assert_allclose(np.asarray(chol).T @ np.asarray(z), b, atol=1e-10)


def test_kronecker_matmul(rng):
    A = rng.standard_normal((3, 4))
    B = rng.standard_normal((5, 2))
    op = Kronecker(Dense(A), Dense(B))
    x = rng.standard_normal((8, 6))
    expected = np.kron(A, B) @ x
    np.testing.assert_allclose(np.asarray(op @ x), expected, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.todense()), np.kron(A, B), atol=1e-12)


def test_block_ops(rng):
    blocks = [[rng.standard_normal((2, 3)), rng.standard_normal((2, 4))],
              [rng.standard_normal((5, 3)), rng.standard_normal((5, 4))]]
    op = Block(blocks)
    dense = np.block(blocks)
    np.testing.assert_allclose(np.asarray(op.todense()), dense, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.T.todense()), dense.T, atol=1e-12)

    bd = BlockDiagonal([Dense(rng.standard_normal((2, 2))), Diagonal(jnp.asarray([1.0, 2.0]))])
    d = np.asarray(bd.todense())
    assert d.shape == (4, 4)
    np.testing.assert_allclose(d[2:, 2:], np.diag([1.0, 2.0]))
    np.testing.assert_allclose(d[:2, 2:], 0.0)


def test_covariance_views():
    arr = jnp.arange(24.0).reshape(2, 3, 4)
    cov = Covariance(arr, (2, 3), (4,))
    assert cov.matrix.shape == (6, 4)
    np.testing.assert_allclose(
        np.asarray(cov.matrix), np.arange(24.0).reshape(6, 4)
    )
    covT = cov.T
    assert covT.shape0 == (4,)
    np.testing.assert_allclose(
        np.asarray(covT.matrix), np.arange(24.0).reshape(6, 4).T
    )


def test_cholesky_auto_jitter_on_singular():
    # Rank-deficient SPD matrix: eager path must still return a finite factor.
    v = jnp.asarray(np.ones((6, 1)))
    gram = v @ v.T
    chol = cholesky(gram)
    assert not bool(jnp.isnan(chol).any())


def test_linop_solve_surface(rng):
    from linpde_gp_tpu.ops.linalg import Dense

    K = random_spd(rng, 7)
    op = Dense(jnp.asarray(K))
    b = rng.standard_normal(7)
    np.testing.assert_allclose(np.asarray(K @ np.asarray(op.solve(b))), b, atol=1e-9)
    L = np.asarray(op.cholesky())
    np.testing.assert_allclose(L @ L.T, K, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray((op.inv() @ jnp.asarray(K))), np.eye(7), atol=1e-8
    )


def test_posterior_checkpoint_roundtrip(rng, tmp_path):
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.utils.serialization import load_posterior, save_posterior

    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.7),
    )
    X = rng.uniform(-1, 1, 6)
    post = prior.condition_on_observations(np.sin(X), X=X, L=lgt.diffops.Derivative(2))
    path = tmp_path / "posterior.pkl"
    save_posterior(path, post)
    restored = load_posterior(path)
    xq = np.linspace(-1, 1, 9)
    np.testing.assert_allclose(
        np.asarray(restored.mean(xq)), np.asarray(post.mean(xq)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(restored.std(xq)), np.asarray(post.std(xq)), atol=1e-12
    )
    # Incremental conditioning continues from the restored state.
    more = restored.condition_on_observations(np.asarray([0.0]), X=np.asarray([0.5]))
    assert np.isfinite(float(more.mean(np.asarray(0.3))))


# ---------------------------------------------------------------------------
# PCG + Nyström preconditioner (ops/linalg/pcg.py)
# ---------------------------------------------------------------------------


def test_pcg_matches_dense_solve():
    from linpde_gp_tpu.ops.linalg.pcg import pcg

    rng_ = np.random.default_rng(7)
    A0 = rng_.standard_normal((40, 40))
    A = A0 @ A0.T + 40 * np.eye(40)
    b = rng_.standard_normal(40)
    res = pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12, maxiter=200)
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(A, b), atol=1e-9)
    assert int(res.iterations) <= 200
    assert float(res.relative_residual) < 1e-11


def test_pcg_zero_rhs():
    from linpde_gp_tpu.ops.linalg.pcg import pcg

    A = jnp.eye(5)
    res = pcg(lambda v: A @ v, jnp.zeros(5), tol=1e-10, maxiter=10)
    np.testing.assert_allclose(np.asarray(res.x), np.zeros(5))
    assert int(res.iterations) == 0


def test_pcg_host_matches_device_pcg():
    """Host-orchestrated CG (split per-iteration device programs; see
    pcg_host) must agree with the fused while_loop pcg — solution,
    iteration count, and residual — including under a Nyström
    preconditioner."""
    from linpde_gp_tpu.ops.linalg.pcg import (
        landmark_indices,
        nystrom_preconditioner,
        pcg,
        pcg_host,
    )

    import linpde_gp_tpu as lgt

    rng_ = np.random.default_rng(5)
    n, sigma_sq = 200, 1e-4
    X = np.sort(rng_.uniform(-1, 1, n))
    k = lgt.kernels.Matern((), nu=2.5, lengthscales=0.5)
    K = np.asarray(k(jnp.asarray(X)[:, None], jnp.asarray(X)[None, :]))
    A = jnp.asarray(K + sigma_sq * np.eye(n))
    b = np.sin(3 * X)
    idx = np.asarray(landmark_indices(n, 50))
    Z = jnp.asarray(X[idx])
    M = nystrom_preconditioner(
        k(Z[:, None], jnp.asarray(X)[None, :]).T, k(Z[:, None], Z[None, :]), sigma_sq
    )

    matvec_j = jax.jit(lambda v: A @ v)
    M_j = jax.jit(lambda r: M(r))
    dev = pcg(matvec_j, jnp.asarray(b), M=M, tol=1e-10, maxiter=500)
    host = pcg_host(matvec_j, b, M=M_j, tol=1e-10, maxiter=500)

    expected = np.linalg.solve(np.asarray(A), b)
    np.testing.assert_allclose(np.asarray(host.x), expected, atol=1e-7)
    assert int(host.iterations) == int(dev.iterations)
    np.testing.assert_allclose(
        float(host.relative_residual), float(dev.relative_residual),
        rtol=1e-3, atol=1e-12,
    )


def test_pcg_block_host_matches_device_block():
    """Host-orchestrated blocked multi-RHS CG must agree with the fused
    pcg_block while_loop — solutions and iteration count."""
    from linpde_gp_tpu.ops.linalg.pcg import pcg_block, pcg_block_host

    rng_ = np.random.default_rng(13)
    n, r = 120, 7
    A0 = rng_.standard_normal((n, n))
    A = jnp.asarray(A0 @ A0.T + n * np.eye(n))
    B = rng_.standard_normal((n, r))
    matvec_j = jax.jit(lambda V: A @ V)
    dev = pcg_block(matvec_j, jnp.asarray(B), tol=1e-11, maxiter=400)
    host = pcg_block_host(matvec_j, B, tol=1e-11, maxiter=400)
    expected = np.linalg.solve(np.asarray(A), B)
    np.testing.assert_allclose(np.asarray(host.x), expected, atol=1e-8)
    np.testing.assert_allclose(np.asarray(dev.x), expected, atol=1e-8)
    assert int(host.iterations) == int(dev.iterations)


def test_iterative_regressor_host_cg_matches_device():
    """IterativeGPRegressor(host_cg=True) — the host-orchestrated CG
    loop — must reproduce the default while_loop solve exactly."""
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops

    rng_ = np.random.default_rng(9)
    n = 256
    X = np.sort(rng_.uniform(-1, 1, n))
    Y = np.sin(3 * X)
    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()), lgt.kernels.Matern((), nu=2.5, lengthscales=0.7)
    )
    D = -1.0 * diffops.Laplacian(())
    kw = dict(L=D, noise_variance=1e-6, tol=1e-10, maxiter=800, precond_rank=64)
    dev = IterativeGPRegressor(prior, X, Y, host_cg=False, **kw)
    host = IterativeGPRegressor(prior, X, Y, host_cg=True, **kw)
    xq = jnp.asarray(np.linspace(-1, 1, 33))
    np.testing.assert_allclose(
        np.asarray(host.representer_weights),
        np.asarray(dev.representer_weights),
        atol=1e-8,
    )
    np.testing.assert_allclose(
        np.asarray(host.mean(xq)), np.asarray(dev.mean(xq)), atol=1e-8
    )
    assert host.solve_info[0] == dev.solve_info[0]
    # Variance: host-orchestrated blocked multi-RHS CG (pcg_block_host)
    # vs the fused lax.map(pcg_block) device path.
    np.testing.assert_allclose(
        np.asarray(host.var(xq, block_size=16)),
        np.asarray(dev.var(xq, block_size=16)),
        rtol=0, atol=1e-8,
    )


def test_iterative_regressor_host_cg_var_anchored():
    """Anchored (block-Schur) variance through the host-CG path must
    match the device path."""
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops

    rng_ = np.random.default_rng(17)
    n = 192
    X = np.sort(rng_.uniform(-1, 1, n))
    Y = np.full(n, 2.0)
    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()), lgt.kernels.Matern((), nu=2.5, lengthscales=0.8)
    )
    D = -1.0 * diffops.Laplacian(())
    kw = dict(
        L=D, noise_variance=1e-6, tol=1e-11, maxiter=1000, precond_rank=48,
        anchor_X=np.asarray([-1.0, 1.0]), anchor_Y=np.asarray([0.0, 1.0]),
        anchor_noise=1e-10,
    )
    dev = IterativeGPRegressor(prior, X, Y, host_cg=False, **kw)
    host = IterativeGPRegressor(prior, X, Y, host_cg=True, **kw)
    xq = jnp.asarray(np.linspace(-1, 1, 41))
    np.testing.assert_allclose(
        np.asarray(host.var(xq, block_size=16)),
        np.asarray(dev.var(xq, block_size=16)),
        rtol=0, atol=1e-8,
    )


def test_nystrom_preconditioner_cuts_iterations():
    """PCG with the Nyström preconditioner must (a) give the same solution
    and (b) need strictly fewer iterations than plain CG on an
    ill-conditioned smooth-kernel Gram."""
    from linpde_gp_tpu.ops.linalg.pcg import (
        landmark_indices,
        nystrom_preconditioner,
        pcg,
    )

    import linpde_gp_tpu as lgt

    rng_ = np.random.default_rng(11)
    n, sigma_sq = 300, 1e-4
    X = np.sort(rng_.uniform(-1, 1, n))
    k = lgt.kernels.Matern((), nu=2.5, lengthscales=0.5)
    K = np.asarray(k(jnp.asarray(X)[:, None], jnp.asarray(X)[None, :]))
    A = jnp.asarray(K + sigma_sq * np.eye(n))
    b = jnp.asarray(np.sin(3 * X))
    matvec = lambda v: A @ v  # noqa: E731

    plain = pcg(matvec, b, tol=1e-10, maxiter=2000)
    idx = np.asarray(landmark_indices(n, 60))
    Z = jnp.asarray(X[idx])
    M = nystrom_preconditioner(
        k(Z[:, None], jnp.asarray(X)[None, :]).T, k(Z[:, None], Z[None, :]), sigma_sq
    )
    pre = pcg(matvec, b, M=M, tol=1e-10, maxiter=2000)

    expected = np.linalg.solve(np.asarray(A), np.asarray(b))
    np.testing.assert_allclose(np.asarray(plain.x), expected, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pre.x), expected, atol=1e-6)
    assert int(pre.iterations) < int(plain.iterations) // 3, (
        int(pre.iterations),
        int(plain.iterations),
    )


def test_iterative_regressor_preconditioned_matches_dense():
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops as dops

    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
    )
    D = -1.0 * dops.Laplacian(())
    X = np.linspace(-1, 1, 150)
    Y = np.full(150, 2.0)
    pre = IterativeGPRegressor(
        prior, X, Y, L=D, noise_variance=1e-8, tol=1e-10, maxiter=4000,
        precond_rank=40,
    )
    dense = prior.condition_on_observations(
        Y, X=X, L=D, b=lgt.Normal(np.zeros(150), 1e-8 * np.eye(150))
    )
    xq = np.linspace(-1, 1, 13)
    np.testing.assert_allclose(
        np.asarray(pre.mean(xq)), np.asarray(dense.mean(xq)), atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(pre.var(xq)), np.asarray(dense.var(xq)), atol=1e-7
    )
    assert pre.solve_info[0] < 4000


def test_pcg_block_matches_direct_solve():
    """Blocked multi-RHS CG: every column solved to tolerance through
    SHARED matvec applications (the variance-sweep workhorse)."""
    import numpy as np
    import jax.numpy as jnp
    from linpde_gp_tpu.ops.linalg.pcg import pcg_block

    rng = np.random.default_rng(5)
    A0 = rng.standard_normal((60, 60))
    A = jnp.asarray(A0 @ A0.T + 60 * np.eye(60))
    B = jnp.asarray(rng.standard_normal((60, 7)))
    res = pcg_block(lambda v: A @ v, B, tol=1e-12, maxiter=300)
    X_ref = jnp.linalg.solve(A, B)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(X_ref), rtol=1e-8, atol=1e-9)
    assert float(res.relative_residual) < 1e-10


def test_iterative_var_blocked_matches_dense():
    """IterativeGPRegressor.var through pcg_block vs the dense posterior."""
    import numpy as np
    import jax.numpy as jnp
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor

    rng = np.random.default_rng(2)
    k = lgt.kernels.Matern((), nu=2.5, lengthscales=0.5)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    X = rng.uniform(-1, 1, 90)
    Y = np.sin(3 * X) + 0.05 * rng.standard_normal(90)
    reg = IterativeGPRegressor(prior, X, Y, noise_variance=1e-4, tol=1e-11, maxiter=600)
    post = prior.condition_on_observations(Y, X=X, b=lgt.models.randvars.Normal(
        np.zeros(90), 1e-4 * np.eye(90)))
    xq = np.linspace(-1, 1, 33)
    v_iter = np.asarray(reg.var(xq, block_size=16))
    v_dense = np.asarray(post.var(xq))
    np.testing.assert_allclose(v_iter, v_dense, rtol=1e-6, atol=1e-9)
