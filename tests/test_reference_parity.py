"""Recorded-fixture parity for the five BASELINE configs.

``tests/fixtures/reference_parity.json`` holds posterior mean/std
computed by the INDEPENDENT dense oracle
(``tests/reference_parity_oracle.py``: hand-derived kernel calculus,
reference ``probnum`` conventions, naive joint-Gram conditioning — the
reference's own oracle pattern,
``tests/linpde_gp/randprocs/test_posterior_gp.py:183-220``).  The tests
drive the LIBRARY's public conditioning path on identical configs and
assert <=1e-6 agreement, closing the "posteriors matching linpde-gp to
1e-6" loop without the unrunnable reference install (its probnum fork
is an empty submodule, ``/root/reference/.gitmodules:1-3``).

Regenerate fixtures (after an INTENTIONAL convention change only):
``python tests/make_reference_fixtures.py``.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

import linpde_gp_tpu as lgt
from linpde_gp_tpu.ops import diffops

FIXTURES = json.load(
    open(os.path.join(os.path.dirname(__file__), "fixtures", "reference_parity.json"))
)
NOISE = FIXTURES["noise"]
TOL = 1e-6


def _noise_b(n, var=NOISE):
    return lgt.Normal(np.zeros(n), var * np.eye(n))


def _check(post, fx, mean_key="mean", std_key="std"):
    xq = np.asarray(fx["xq"])
    mean = np.asarray(post.mean(jnp.asarray(xq)))
    std = np.asarray(post.std(jnp.asarray(xq)))
    ref_mean = np.asarray(fx[mean_key])
    ref_std = np.asarray(fx[std_key])
    scale = max(np.max(np.abs(ref_mean)), 1.0)
    np.testing.assert_allclose(mean, ref_mean, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(std, ref_std, rtol=TOL, atol=TOL * scale)


def test_parity_poisson_1d():
    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()), 2.0**2 * lgt.kernels.ExpQuad((), lengthscales=1.0)
    )
    X_pde = np.linspace(-0.8, 0.8, 8)
    post = prior.condition_on_observations(
        np.full(8, 2.0), X=X_pde, L=-1.0 * diffops.Laplacian(()), b=_noise_b(8)
    )
    post = post.condition_on_observations(
        np.asarray([0.0, 1.0]), X=np.asarray([-1.0, 1.0]), b=_noise_b(2)
    )
    _check(post, FIXTURES["poisson_1d"])


def test_parity_heat_1d():
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    x_ic = np.linspace(-1.0 + 1e-6, 1.0 - 1e-6, 7)
    X_ic = np.stack([np.zeros(7), x_ic], -1)
    Y_ic = np.sin(np.pi * 0.5 * (x_ic + 1.0))
    post = prior.condition_on_observations(Y_ic, X=X_ic, b=_noise_b(7))
    t_bc = np.linspace(0.0, 5.0, 6)
    for xb in (-1.0, 1.0):
        X_bc = np.stack([t_bc, np.full(6, xb)], -1)
        post = post.condition_on_observations(np.zeros(6), X=X_bc, b=_noise_b(6))
    tg = np.linspace(0.0, 5.0, 8)
    xg = np.linspace(-1.0, 1.0, 5)
    X_pde = np.stack(np.meshgrid(tg, xg, indexing="ij"), -1).reshape(-1, 2)
    post = post.condition_on_observations(
        np.zeros(40), X=X_pde, L=diffops.HeatOperator((2,), alpha=0.1),
        b=_noise_b(40),
    )
    _check(post, FIXTURES["heat_1d"])


def test_parity_poisson_2d():
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
            lgt.kernels.Matern((), nu=2.5, lengthscales=1.0),
        ),
    )
    e = 1e-6
    s = np.linspace(-1.0 + e, 1.0 - e, 5)
    post = prior
    for edge in (
        np.stack([np.full(5, -1.0), s], -1),
        np.stack([np.full(5, 1.0), s], -1),
        np.stack([s, np.full(5, -1.0)], -1),
        np.stack([s, np.full(5, 1.0)], -1),
    ):
        post = post.condition_on_observations(np.zeros(5), X=edge, b=_noise_b(5))
    g = np.linspace(-1.0, 1.0, 5)
    X_pde = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    post = post.condition_on_observations(
        np.full(25, 2.0), X=X_pde, L=-1.0 * diffops.Laplacian((2,)),
        b=_noise_b(25),
    )
    _check(post, FIXTURES["poisson_2d"])


def test_parity_poisson_fem():
    from linpde_gp_tpu.models.functions import UnivariateLinearInterpolationBasis

    num_elements = 5
    basis_grid = np.linspace(-1.0, 1.0, num_elements + 2)
    trial_basis = UnivariateLinearInterpolationBasis(basis_grid, zero_boundary=False)
    test_basis = UnivariateLinearInterpolationBasis(basis_grid, zero_boundary=True)
    trial_proj = trial_basis.l2_projection()
    test_proj = test_basis.l2_projection(normalized=False)
    D = -1.0 * diffops.Laplacian(())
    diffop_galerkin = D.weak_form(test_basis)(trial_basis)
    rhs_galerkin = np.asarray(test_proj(lgt.functions.Constant((), 2.0)))

    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()), 1.0 * lgt.kernels.Matern((), nu=1.5, lengthscales=1.0)
    )
    post = prior.condition_on_observations(
        np.asarray([0.0, 1.0]), X=np.asarray([-1.0, 1.0]), b=_noise_b(2)
    )
    post = post.condition_on_observations(
        rhs_galerkin, L=diffop_galerkin @ trial_proj,
        b=_noise_b(len(rhs_galerkin)),
    )
    _check(post, FIXTURES["poisson_fem"])


def test_parity_poisson_inverse_rhs():
    mu_c, sig = 0.4, 0.3
    u_true = lgt.functions.LambdaFunction(
        lambda x: jnp.exp(-0.5 / sig**2 * (x - mu_c) ** 2), ()
    )
    u_prior = lgt.GaussianProcess(
        lgt.functions.Zero(()), 1.0 * lgt.kernels.ExpQuad((), lengthscales=0.5)
    )
    f_prior = lgt.GaussianProcess(
        lgt.functions.Zero(()), 10.0**2 * lgt.kernels.ExpQuad((), lengthscales=0.25)
    )
    D = -1.0 * diffops.Laplacian(())

    X_bc = np.asarray([-1.0, 1.0])
    Y_bc = np.asarray(u_true(jnp.asarray(X_bc)))
    X_meas = np.linspace(-1.0, 1.0, 12)[1:-1]
    Y_meas = np.asarray(u_true(jnp.asarray(X_meas)))

    u_bc = u_prior.condition_on_observations(Y_bc, X=X_bc, b=_noise_b(2))
    u_bc_meas = u_bc.condition_on_observations(
        Y_meas, X=X_meas, b=_noise_b(10, 0.1**2)
    )
    u_post = u_bc_meas.condition_on_observations(
        np.zeros(10), X=X_meas, L=D,
        b=(-1.0 * f_prior(X_meas)) + lgt.Normal(np.zeros(10), NOISE * np.eye(10)),
    )
    fx = FIXTURES["poisson_inverse_rhs"]
    _check(u_post, fx, mean_key="u_mean", std_key="u_std")

    X_pde = np.linspace(-1.0, 1.0, 10)
    Lu = D(u_bc_meas)(X_pde)
    f_post = f_prior.condition_on_observations(
        np.zeros(10), X=X_pde,
        b=(-1.0 * Lu) + lgt.Normal(np.zeros(10), NOISE * np.eye(10)),
    )
    _check(f_post, fx, mean_key="f_mean", std_key="f_std")
