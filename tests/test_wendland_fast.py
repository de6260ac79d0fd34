"""Wendland as a first-class fast kernel: closed-form diffop transforms
(matching the autodiff oracle off-diagonal and exact at d=0), term-spec
routing through the fused/native Gram family, and compact-support
structure.

Reference anchor: ``covfuncs/_wendland.py:23-245`` — the reference
routes Wendland through KeOps but has NO diffop closed forms for it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import linpde_gp_tpu as lgt
from linpde_gp_tpu.ops import diffops
from linpde_gp_tpu.ops.kernels.wendland import WendlandCovarianceFunction
from linpde_gp_tpu.ops.gram import gram_matrix, kernel_term_specs, terms_gram
from linpde_gp_tpu.ops.transforms import (
    AutodiffTransformedKernel,
    SumOfProductsKernel,
    apply_operator_to_kernel,
    as_coefficients,
)

rng = np.random.default_rng(7)


@pytest.mark.parametrize("k_smooth", [1, 2, 3])
def test_wendland_derivative_pairs_match_autodiff_oracle(k_smooth):
    """∂^m ∂^n transforms vs the JAX jvp/hessian oracle off-diagonal
    (pattern §4.1); total order capped at the kernel smoothness 2k."""
    k = WendlandCovarianceFunction((), k=k_smooth, lengthscales=0.7)
    for m in range(k_smooth + 1):
        for n in range(k_smooth + 1):
            if m == n == 0:
                continue
            L0 = diffops.Derivative(m) if m else None
            L1 = diffops.Derivative(n) if n else None
            kk = k
            if L1 is not None:
                kk = apply_operator_to_kernel(L1, kk, argnum=1)
            if L0 is not None:
                kk = apply_operator_to_kernel(L0, kk, argnum=0)
            assert isinstance(kk, SumOfProductsKernel), type(kk)
            oracle = AutodiffTransformedKernel(
                k,
                None if L0 is None else as_coefficients(L0),
                None if L1 is None else as_coefficients(L1),
            )
            # Off-diagonal points inside and OUTSIDE the support.
            x0 = rng.uniform(-1.5, 1.5, (9, 1))
            x1 = rng.uniform(-1.5, 1.5, (1, 8))
            a = np.asarray(kk(jnp.asarray(x0), jnp.asarray(x1)))
            b = np.asarray(oracle(jnp.asarray(x0), jnp.asarray(x1)))
            np.testing.assert_allclose(a, b, atol=1e-8)


def test_wendland_diagonal_exact():
    """Closed form is exact at d = 0 where autodiff through |d| breaks:
    Var[u'(x)] = -phi''(0) / l^2."""
    l = 0.6
    k = WendlandCovarianceFunction((), k=2, lengthscales=l)
    kk = apply_operator_to_kernel(
        diffops.Derivative(1),
        apply_operator_to_kernel(diffops.Derivative(1), k, argnum=1),
        argnum=0,
    )
    from linpde_gp_tpu.ops.kernels.wendland import wendland_polynomial

    p = wendland_polynomial(1, 2)
    phi_dd0 = float(p.differentiate().differentiate().coefficients[0])
    val = float(kk(jnp.asarray(0.2), jnp.asarray(0.2)))
    np.testing.assert_allclose(val, -phi_dd0 / l**2, rtol=1e-12)
    # Continuity: the d -> 0 limit of the off-diagonal expression.
    eps_val = float(kk(jnp.asarray(0.2 + 1e-8), jnp.asarray(0.2)))
    np.testing.assert_allclose(eps_val, val, rtol=1e-5)


def test_wendland_term_specs_and_pallas_gram():
    """Wendland belongs to the fast sum-of-products Gram family: term
    specs exist, the fused closed-form assembler matches broadcast
    evaluation, and compact support produces exact zeros."""
    k = WendlandCovarianceFunction((), k=1, lengthscales=0.15)
    spec = kernel_term_specs(k)
    assert spec is not None, "Wendland must be in the fast-Gram family"
    scale, terms = spec
    X0 = rng.uniform(0, 1, (40, 1))
    X1 = rng.uniform(0, 1, (56, 1))
    G = scale * np.asarray(terms_gram(terms, jnp.asarray(X0), jnp.asarray(X1)))
    ref = np.asarray(k.matrix(jnp.asarray(X0[:, 0]), jnp.asarray(X1[:, 0])))
    np.testing.assert_allclose(G, ref, atol=1e-13)
    # Sparsity: pairs farther than the support radius are exactly zero.
    d = np.abs(X0[:, 0][:, None] - X1[:, 0][None, :])
    assert np.all(G[d > 0.15] == 0.0)
    assert np.mean(G != 0.0) < 0.5  # structurally sparse at this l


def test_wendland_tensor_product_diffop():
    """TensorProduct of Wendlands distributes diffops dimension-wise
    (the Laplacian closed form in 2-D)."""
    k = lgt.kernels.TensorProduct(
        WendlandCovarianceFunction((), k=2, lengthscales=0.5),
        WendlandCovarianceFunction((), k=2, lengthscales=0.4),
    )
    lap = diffops.Laplacian((2,))
    kk = apply_operator_to_kernel(
        lap, apply_operator_to_kernel(lap, k, argnum=1), argnum=0
    )
    assert isinstance(kk, SumOfProductsKernel)
    oracle = AutodiffTransformedKernel(
        k, as_coefficients(lap), as_coefficients(lap)
    )
    x0 = rng.uniform(-0.7, 0.7, (6, 2))
    x1 = rng.uniform(-0.7, 0.7, (5, 2))
    a = np.asarray(kk(jnp.asarray(x0[:, None]), jnp.asarray(x1[None, :])))
    b = np.asarray(oracle(jnp.asarray(x0[:, None]), jnp.asarray(x1[None, :])))
    np.testing.assert_allclose(a, b, atol=1e-7)


def test_wendland_poisson_conditioning_end_to_end():
    """Condition a Wendland-prior GP on -u'' = f observations + BCs; the
    posterior mean must interpolate the PDE residual (engine-level check
    that the closed forms drive the full stack)."""
    bvp = lgt.problems.PoissonEquationDirichletProblem(
        domain=lgt.domains.asdomain([-1.0, 1.0]),
        rhs=lgt.functions.Constant((), 2.0),
        boundary_values=(0.0, 1.0),
    )
    prior = lgt.GaussianProcess(
        mean=lgt.functions.Zero(()),
        cov=2.0**2 * WendlandCovarianceFunction((), k=3, lengthscales=2.5),
    )
    X_pde = bvp.domain.uniform_grid((40,), inset=0.0)
    Y_pde = np.asarray(bvp.pde.rhs(X_pde))
    X_bc, Y_bc = lgt.problems.get_1d_dirichlet_boundary_observations(
        bvp.boundary_conditions
    )
    post = prior.condition_on_observations(Y_pde, X=X_pde, L=bvp.pde.diffop)
    post = post.condition_on_observations(Y_bc, X=X_bc)
    grid = np.linspace(-1, 1, 120)
    mean = np.asarray(post.mean(grid))
    sol = np.asarray(bvp.solution(grid))
    assert np.max(np.abs(mean - sol)) < 2e-3  # compact support limits reach
    # BCs interpolated.
    np.testing.assert_allclose(np.asarray(post.mean(np.asarray(X_bc))), Y_bc, atol=1e-6)


def test_banded_matvec_matches_dense_1d():
    """Banded matvec (compact-support tile skipping) vs the dense Gram
    product, unsorted points, 1-D."""
    from linpde_gp_tpu.ops.gram import make_banded_matvec

    k = 1.7 * WendlandCovarianceFunction((), k=2, lengthscales=0.05)
    spec = kernel_term_specs(k)
    X0 = rng.uniform(0.0, 1.0, 300)
    X1 = rng.uniform(0.0, 1.0, 1500)
    mv = make_banded_matvec(spec, X0, X1, tile0=128, tile1=128)
    v = rng.standard_normal(1500)
    dense = np.asarray(k.matrix(jnp.asarray(X0), jnp.asarray(X1))) @ v
    np.testing.assert_allclose(np.asarray(mv(v)), dense, rtol=0, atol=1e-12)
    # The schedule must actually skip tiles at this radius/domain ratio
    # (support 0.05 on a unit domain, 128-point tiles over 1500 points).
    assert mv.band_tiles < mv.total_tiles
    # Multi-RHS path.
    V = rng.standard_normal((1500, 3))
    denseV = np.asarray(k.matrix(jnp.asarray(X0), jnp.asarray(X1))) @ V
    np.testing.assert_allclose(np.asarray(mv(V)), denseV, rtol=0, atol=1e-12)


def test_banded_matvec_diffop_transformed_2d():
    """Banding survives diffop transforms (derivatives keep the support)
    and tensor-product kernels: band on dim 0, full range on dim 1."""
    from linpde_gp_tpu.ops.gram import (
        compact_support_radius,
        make_banded_matvec,
    )

    k = lgt.kernels.TensorProduct(
        WendlandCovarianceFunction((), k=2, lengthscales=0.08),
        WendlandCovarianceFunction((), k=2, lengthscales=0.3),
    )
    D = diffops.PartialDerivative((1, 0))
    kk = apply_operator_to_kernel(
        D, apply_operator_to_kernel(D, k, argnum=1), argnum=0
    )
    spec = kernel_term_specs(kk)
    assert compact_support_radius(spec[1], 0) == pytest.approx(0.08)
    X = rng.uniform(0.0, 1.0, (256, 2))
    mv = make_banded_matvec(spec, X, X)
    v = rng.standard_normal(256)
    dense = np.asarray(kk.matrix(jnp.asarray(X))) @ v
    np.testing.assert_allclose(np.asarray(mv(v)), dense, rtol=1e-9, atol=1e-10)


def test_banded_matvec_radius_covers_domain():
    """Radius larger than the domain degrades to the full band and stays
    exact; non-compact kernels require an explicit radius."""
    from linpde_gp_tpu.ops.gram import make_banded_matvec

    k = WendlandCovarianceFunction((), k=1, lengthscales=5.0)
    spec = kernel_term_specs(k)
    X = rng.uniform(0.0, 1.0, 150)
    mv = make_banded_matvec(spec, X, X)
    v = rng.standard_normal(150)
    dense = np.asarray(k.matrix(jnp.asarray(X))) @ v
    np.testing.assert_allclose(np.asarray(mv(v)), dense, rtol=0, atol=1e-12)

    km = lgt.kernels.Matern((), nu=1.5, lengthscales=0.3)
    with pytest.raises(ValueError, match="not compactly supported"):
        make_banded_matvec(kernel_term_specs(km), X, X)


def test_iterative_regressor_routes_banded():
    """Compact-support kernels route the CG matvec through the banded
    schedule automatically."""
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor

    rng = np.random.default_rng(31)
    # Routing + correctness are size-independent (large-n run:
    # experiments/wendland_banded.py).
    n = 768
    X = np.sort(rng.uniform(0.0, 15.0, n))
    Y = np.sin(X)
    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        lgt.kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.5),
    )
    prev_tile = lgt.config.band_tile
    lgt.config.set(band_tile=64)  # band granularity at this small n
    try:
        reg = IterativeGPRegressor(
            prior, X, Y, noise_variance=1e-3, tol=1e-8, maxiter=600,
            precond_rank=128,
        )
        assert reg._banded is not None, "banded matvec not routed"
        assert reg._banded.band_tiles < reg._banded.total_tiles

        w = np.asarray(reg.representer_weights)
        # Dense oracle (CG tol 1e-8 leaves ~1e-6 relative weight error on
        # this ill-conditioned compact-support Gram).
        G = np.asarray(prior.cov.matrix(jnp.asarray(X))) + 1e-3 * np.eye(n)
        w_ref = np.linalg.solve(G, Y)
        np.testing.assert_allclose(
            w, w_ref, rtol=0, atol=1e-5 * np.abs(w_ref).max()
        )

        xq = np.linspace(0.0, 15.0, 64)
        mean = np.asarray(reg.mean(jnp.asarray(xq)))
        ref = np.asarray(prior.cov.matrix(jnp.asarray(xq), jnp.asarray(X))) @ w_ref
        np.testing.assert_allclose(mean, ref, rtol=0, atol=1e-6)
    finally:
        lgt.config.set(band_tile=prev_tile)
