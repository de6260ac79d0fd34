"""Mixed-precision iterative refinement (``ops/linalg/refine.py``).

Float32 factorization speed at the reference's 1e-6 parity target
(``BASELINE.md`` row 3; reference asserts float64 machine precision in
``tests/linpde_gp/randprocs/test_posterior_gp.py:152-162``): float32
O(n^3) factor + float64 preconditioned-CG refinement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import linpde_gp_tpu as lgt
from linpde_gp_tpu.config import config
from linpde_gp_tpu.ops.linalg.refine import refined_solve


def _poisson_posterior():
    bvp = lgt.problems.PoissonEquationDirichletProblem(
        domain=lgt.domains.asdomain([-1.0, 1.0]),
        rhs=lgt.functions.Constant((), 2.0),
        boundary_values=(0.0, 1.0),
    )
    prior = lgt.GaussianProcess(
        mean=lgt.functions.Zero(()),
        cov=2.0**2 * lgt.kernels.ExpQuad((), lengthscales=1.0),
    )
    X_pde = bvp.domain.uniform_grid((20,), inset=0.0)
    Y_pde = np.asarray(bvp.pde.rhs(X_pde))
    X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(
        bvp.boundary_conditions
    )
    post = prior.condition_on_observations(Y_pde, X=X_pde, L=bvp.pde.diffop)
    post = post.condition_on_observations(Y_bc, X=X_bc)
    return bvp, post


def test_refined_solve_matches_direct():
    """On a well-conditioned SPD system the refined solve reproduces the
    float64 direct solution to round-off."""
    rng = np.random.default_rng(0)
    A0 = rng.standard_normal((40, 40))
    gram = jnp.asarray(A0 @ A0.T + 40 * np.eye(40))
    b = jnp.asarray(rng.standard_normal((40, 3)))
    chol32 = jnp.linalg.cholesky(gram.astype(jnp.float32))
    x = refined_solve(gram, chol32, b)
    x_ref = jnp.linalg.solve(gram, b)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), rtol=1e-9, atol=1e-10)


def test_refined_poisson_1d_hits_1e6_parity():
    """Poisson-1D Dirichlet (the singular-to-machine-precision config):
    float32 factor + refinement must match the analytic solution below
    the 1e-6 parity target — plain float32 sits at ~1.8e-4."""
    config.set(solve_refinement=True)
    try:
        bvp, post = _poisson_posterior()
        assert post.gram_cholesky.dtype == jnp.float32
        grid = np.linspace(-1, 1, 200)
        mean = np.asarray(post.mean(grid))
        std = np.asarray(post.std(grid))
    finally:
        config.set(solve_refinement=False)
    sol = np.asarray(bvp.solution(grid))
    assert np.max(np.abs(mean - sol)) < 1e-6
    # Posterior std must stay finite/nonnegative through the refined
    # covariance path.
    assert np.all(np.isfinite(std)) and np.all(std >= 0)

    # Compare against the pure-float64 posterior moments.
    bvp, post64 = _poisson_posterior()
    mean64 = np.asarray(post64.mean(grid))
    std64 = np.asarray(post64.std(grid))
    assert np.max(np.abs(mean - mean64)) < 1e-6
    assert np.max(np.abs(std - std64)) < 1e-5


def test_refined_operator_pushforward_keeps_solver():
    """Pushing an operator through a refined posterior must keep the
    refined solver (factor stays float32, moments stay accurate)."""
    from linpde_gp_tpu.ops import diffops

    config.set(solve_refinement=True)
    try:
        bvp, post = _poisson_posterior()
        ddu = diffops.Derivative(2)(post)
        assert ddu.gram_cholesky.dtype == jnp.float32
        grid = np.linspace(-0.9, 0.9, 50)
        mean = np.asarray(ddu.mean(grid))
    finally:
        config.set(solve_refinement=False)
    # The PDE is -u'' = 2, so the posterior of u'' interpolates -2.
    np.testing.assert_allclose(mean, -2.0, atol=1e-5)
