"""Incremental conditioning engine vs a naive hand-rolled Cholesky GP
conditioner (reference test pattern §4.3,
``tests/linpde_gp/randprocs/test_posterior_gp.py:120-220``)."""

import jax.numpy as jnp
import numpy as np
import pytest

import linpde_gp_tpu as lgt
from linpde_gp_tpu.ops import diffops

rng = np.random.default_rng(7)


def naive_gp_regression(kernel_fns, X_blocks, Y_blocks, noise_blocks, mean_fn, x_query, query_kernels):
    """Dense one-shot conditioner: assemble the full Gram over all blocks
    with scipy-free numpy, solve, and predict."""
    K = np.block(
        [
            [np.asarray(kernel_fns[(i, j)](Xi[:, None], Xj[None, :])) for j, Xj in enumerate(X_blocks)]
            for i, Xi in enumerate(X_blocks)
        ]
    )
    for idx, nb in enumerate(noise_blocks):
        if nb is not None:
            start = sum(len(X_blocks[k]) for k in range(idx))
            sl = slice(start, start + len(X_blocks[idx]))
            K[sl, sl] += nb
    y = np.concatenate([np.asarray(Y) for Y in Y_blocks])
    prior_means = np.concatenate(
        [np.zeros(len(X)) for X in X_blocks]
    )
    w = np.linalg.solve(K, y - prior_means)
    kx = np.concatenate(
        [np.asarray(qk(x_query[:, None], Xj[None, :])) for qk, Xj in zip(query_kernels, X_blocks)],
        axis=1,
    )
    mean = kx @ w
    return mean, K, w, kx


def test_incremental_vs_naive_point_observations():
    k = lgt.kernels.Matern((), nu=2.5, lengthscales=0.7)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)

    X1 = rng.uniform(-1, 1, 5)
    X2 = rng.uniform(-1, 1, 4)
    Y1 = np.sin(3 * X1)
    Y2 = np.sin(3 * X2)
    noise2 = 0.1**2 * np.eye(4)

    post = prior.condition_on_observations(Y1, X=X1)
    post = post.condition_on_observations(
        Y2, X=X2, b=lgt.Normal(np.zeros(4), noise2)
    )

    xq = np.linspace(-1, 1, 33)
    mean, K, w, kx = naive_gp_regression(
        {(i, j): k for i in range(2) for j in range(2)},
        [X1, X2],
        [Y1, Y2],
        [None, noise2],
        None,
        xq,
        [k, k],
    )
    np.testing.assert_allclose(np.asarray(post.mean(xq)), mean, atol=1e-8)

    # Variance against naive.
    kxx = np.asarray(k(xq, xq))
    var_naive = kxx - np.einsum("qn,nm,qm->q", kx, np.linalg.inv(K), kx)
    np.testing.assert_allclose(np.asarray(post.var(xq)), var_naive, atol=1e-8)

    # Full posterior covariance matrix.
    cov_naive = np.asarray(k(xq[:, None], xq[None, :])) - kx @ np.linalg.inv(K) @ kx.T
    np.testing.assert_allclose(
        np.asarray(post.cov.matrix(xq)), cov_naive, atol=1e-8
    )


def test_incremental_order_invariance():
    """Conditioning on (A then B) must equal conditioning on (B then A)
    and on (A and B jointly)."""
    k = 2.0**2 * lgt.kernels.ExpQuad((), lengthscales=0.5)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    XA = np.asarray([-0.7, -0.2, 0.4])
    XB = np.asarray([0.1, 0.8])
    YA = np.cos(XA)
    YB = np.cos(XB)

    ab = prior.condition_on_observations(YA, X=XA).condition_on_observations(YB, X=XB)
    ba = prior.condition_on_observations(YB, X=XB).condition_on_observations(YA, X=XA)
    joint = prior.condition_on_observations(
        np.concatenate([YA, YB]), X=np.concatenate([XA, XB])
    )
    xq = np.linspace(-1, 1, 17)
    np.testing.assert_allclose(np.asarray(ab.mean(xq)), np.asarray(ba.mean(xq)), atol=1e-9)
    np.testing.assert_allclose(np.asarray(ab.mean(xq)), np.asarray(joint.mean(xq)), atol=1e-9)
    np.testing.assert_allclose(np.asarray(ab.var(xq)), np.asarray(joint.var(xq)), atol=1e-9)


def test_operator_observations_vs_naive():
    """PDE-operator observations: Gram blocks are L0 k L1* evaluations."""
    k = lgt.kernels.ExpQuad((), lengthscales=0.8)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    D = diffops.Derivative(2)

    X_op = rng.uniform(-1, 1, 6)
    Y_op = np.ones(6)
    X_pt = np.asarray([-1.0, 1.0])
    Y_pt = np.asarray([0.0, 0.5])

    post = prior.condition_on_observations(Y_op, X=X_op, L=D)
    post = post.condition_on_observations(Y_pt, X=X_pt)

    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel

    k_dd = apply_operator_to_kernel(D, apply_operator_to_kernel(D, k, argnum=1), argnum=0)
    k_id_d = apply_operator_to_kernel(D, k, argnum=1)
    k_d_id = apply_operator_to_kernel(D, k, argnum=0)

    xq = np.linspace(-1, 1, 21)
    mean, K, w, kx = naive_gp_regression(
        {(0, 0): k_dd, (0, 1): k_d_id, (1, 0): k_id_d, (1, 1): k},
        [X_op, X_pt],
        [Y_op, Y_pt],
        [None, None],
        None,
        xq,
        [k_id_d, k],
    )
    np.testing.assert_allclose(np.asarray(post.mean(xq)), mean, atol=1e-7)


def test_operator_pushforward_reuses_weights():
    """L(posterior) shares the Gram factor and matches naive computation
    (reference §3.3)."""
    k = lgt.kernels.ExpQuad((), lengthscales=0.8)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    X = rng.uniform(-1, 1, 5)
    Y = np.sin(2 * X)
    post = prior.condition_on_observations(Y, X=X)
    d1 = diffops.Derivative(1)
    dpost = d1(post)
    assert dpost.gram_cholesky is post.gram_cholesky

    # d/dx of posterior mean by finite differences.
    xq = np.linspace(-0.9, 0.9, 11)
    h = 1e-6
    fd = (np.asarray(post.mean(xq + h)) - np.asarray(post.mean(xq - h))) / (2 * h)
    np.testing.assert_allclose(np.asarray(dpost.mean(xq)), fd, atol=1e-5)


def test_functional_application_to_posterior():
    """lambda(posterior) -> Normal with covariance through the cached
    factor (reference ``_conditional.py:453-467``)."""
    k = lgt.kernels.ExpQuad((), lengthscales=0.8)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    X = rng.uniform(-1, 1, 5)
    Y = np.sin(2 * X)
    post = prior.condition_on_observations(Y, X=X)

    rv = post(np.asarray([0.1, 0.2]))
    assert isinstance(rv, lgt.Normal)
    np.testing.assert_allclose(
        np.asarray(rv.mean), np.asarray(post.mean(np.asarray([0.1, 0.2]))), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(rv.var), np.asarray(post.var(np.asarray([0.1, 0.2]))), atol=1e-10
    )


def test_noise_via_gp_evaluation():
    """Inverse-problem pattern: b = -f_prior(X) (a Normal) as correlated
    noise (reference ``0003_poisson_1d_inverse_rhs.ipynb``)."""
    u_prior = lgt.GaussianProcess(
        lgt.functions.Zero(()), lgt.kernels.ExpQuad((), lengthscales=0.5)
    )
    f_prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        10.0**2 * lgt.kernels.ExpQuad((), lengthscales=0.25),
    )
    X = np.linspace(-0.8, 0.8, 5)
    b = -f_prior(X)
    assert isinstance(b, lgt.Normal)
    D = diffops.Derivative(2)
    post = u_prior.condition_on_observations(
        np.zeros_like(X), X=X, L=-1.0 * D, b=b
    )
    # Finite values everywhere.
    xq = np.linspace(-1, 1, 9)
    assert np.all(np.isfinite(np.asarray(post.mean(xq))))
    assert np.all(np.isfinite(np.asarray(post.std(xq))))


def test_iterative_gram_free_regressor_matches_dense():
    """CG + gram-free matvec conditioning equals the dense engine
    (beyond-reference scale path, models/iterative.py)."""
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops as dops

    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
    )
    D = -1.0 * dops.Laplacian(())
    X = np.linspace(-1, 1, 120)
    Y = np.full(120, 2.0)
    it = IterativeGPRegressor(
        prior, X, Y, L=D, noise_variance=1e-8, tol=1e-10, maxiter=2000
    )
    dense = prior.condition_on_observations(
        Y, X=X, L=D, b=lgt.Normal(np.zeros(120), 1e-8 * np.eye(120))
    )
    xq = np.linspace(-1, 1, 17)
    np.testing.assert_allclose(
        np.asarray(it.mean(xq)), np.asarray(dense.mean(xq)), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(it.var(xq)), np.asarray(dense.var(xq)), atol=1e-8
    )


def test_iterative_regressor_anchored_matches_dense_joint():
    """Anchored gram-free conditioning (block Schur elimination of a
    small evaluation batch against the large streaming operator batch)
    equals the dense multi-batch engine — the mixed IC/BC + PDE setup of
    the reference's heat experiment (``0002_heat_1d.ipynb``) at
    gram-free scale."""
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops as dops

    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
    )
    D = -1.0 * dops.Laplacian(())
    X = np.linspace(-0.95, 0.95, 120)  # PDE collocation (interior)
    Y = np.full(120, 2.0)
    X_b = np.asarray([-1.0, 1.0])  # boundary anchors
    Y_b = np.asarray([0.0, 1.0])
    noise, bnoise = 1e-8, 1e-10

    it = IterativeGPRegressor(
        prior, X, Y, L=D, noise_variance=noise, tol=1e-12, maxiter=4000,
        anchor_X=X_b, anchor_Y=Y_b, anchor_noise=bnoise,
    )
    dense = prior.condition_on_observations(
        Y_b, X=X_b, b=lgt.Normal(np.zeros(2), bnoise * np.eye(2))
    ).condition_on_observations(
        Y, X=X, L=D, b=lgt.Normal(np.zeros(120), noise * np.eye(120))
    )
    xq = np.linspace(-1, 1, 17)
    np.testing.assert_allclose(
        np.asarray(it.mean(xq)), np.asarray(dense.mean(xq)), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(it.var(xq)), np.asarray(dense.var(xq)), atol=1e-8
    )


def test_log_marginal_likelihood_vs_scipy():
    import scipy.stats

    k = lgt.kernels.Matern((), nu=2.5, lengthscales=0.7)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    X = rng.uniform(-1, 1, 6)
    Y = np.sin(2 * X)
    noise = 0.05**2 * np.eye(6)
    post = prior.condition_on_observations(Y, X=X, b=lgt.Normal(np.zeros(6), noise))
    K = np.asarray(k(X[:, None], X[None, :])) + noise
    expected = scipy.stats.multivariate_normal(np.zeros(6), K).logpdf(Y)
    np.testing.assert_allclose(
        float(post.log_marginal_likelihood), expected, rtol=1e-10
    )
    # Incremental conditioning accumulates the joint evidence.
    X2 = rng.uniform(-1, 1, 3)
    Y2 = np.sin(2 * X2)
    post2 = post.condition_on_observations(Y2, X=X2)
    K_joint = np.array(
        k(np.concatenate([X, X2])[:, None], np.concatenate([X, X2])[None, :])
    )
    K_joint[:6, :6] += noise
    expected2 = scipy.stats.multivariate_normal(
        np.zeros(9), K_joint, allow_singular=True
    ).logpdf(np.concatenate([Y, Y2]))
    np.testing.assert_allclose(
        float(post2.log_marginal_likelihood), expected2, rtol=1e-8
    )


def test_iterative_kronecker_gram_matvec_on_grids():
    """On a TensorProductGrid the iterative solver must route Gram
    matvecs through the sum-of-Kronecker structure (O(N·Σnᵢ) instead of
    O(N²); reference Kronecker shortcut ``covfuncs/_tensor_product.py:
    64-82`` applied to the whole solve) and agree with a dense oracle."""
    import scipy.linalg

    from linpde_gp_tpu.models.domains.grid import TensorProductGrid
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops
    from linpde_gp_tpu.ops.gram import gram_matrix

    k = 1.3 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=0.8),
        lgt.kernels.Matern((), nu=2.5, lengthscales=0.5),
    )
    prior = lgt.GaussianProcess(lgt.functions.Zero((2,), ()), k)
    H = diffops.HeatOperator((2,), alpha=0.4)
    X = TensorProductGrid(np.linspace(0, 2, 12), np.linspace(-1, 1, 9))
    Xf = np.asarray(X).reshape(-1, 2)
    Y = np.sin(Xf[:, 0]) * np.cos(2 * Xf[:, 1])

    reg = IterativeGPRegressor(
        prior, X, Y, L=H, noise_variance=1e-8, tol=1e-12, maxiter=2000,
        precond_rank=0,
    )
    assert reg._gram_linop is not None, "Kronecker gram structure not engaged"

    G = np.asarray(gram_matrix(reg._k_obs, jnp.asarray(Xf)))
    v = np.random.default_rng(0).standard_normal(Xf.shape[0])
    mv = np.asarray(reg._gram_linop @ jnp.asarray(v))
    np.testing.assert_allclose(mv, G @ v, atol=1e-10)

    Xq = np.random.default_rng(1).uniform(0, 1, (25, 2))
    w = scipy.linalg.solve(G + 1e-8 * np.eye(G.shape[0]), Y, assume_a="pos")
    C = np.asarray(gram_matrix(reg._k_cross, jnp.asarray(Xq), jnp.asarray(Xf)))
    np.testing.assert_allclose(
        np.asarray(reg.mean(jnp.asarray(Xq))), C @ w, atol=1e-8
    )
