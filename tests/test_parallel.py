"""Multi-device tests on a virtual 8-device CPU mesh: sharded paths must
match the single-device dense paths (the reference's KeOps-vs-dense
toggle test is the template, SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import linpde_gp_tpu as lgt
from linpde_gp_tpu.ops.linalg import cho_solve, cholesky
from linpde_gp_tpu.parallel import (
    distributed_chol_solve,
    distributed_cholesky,
    make_mesh,
    sharded_gram,
    sharded_posterior_eval,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

rng = np.random.default_rng(11)


def test_sharded_gram_matches_dense():
    mesh = make_mesh(8)
    k = 2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.7)
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel
    from linpde_gp_tpu.ops import diffops

    kk = apply_operator_to_kernel(
        diffops.Derivative(2),
        apply_operator_to_kernel(diffops.Derivative(2), k, argnum=1),
        argnum=0,
    )
    X0 = rng.uniform(-1, 1, 64)
    X1 = rng.uniform(-1, 1, 32)
    G = sharded_gram(kk, X0, X1, mesh=mesh)
    dense = kk.matrix(jnp.asarray(X0), jnp.asarray(X1))
    np.testing.assert_allclose(np.asarray(G), np.asarray(dense), atol=1e-12)


def test_distributed_cholesky_matches_dense():
    # 4-device submesh, 4 unrolled steps: the 8-device/16-step depth is
    # covered by the slow tier + dryrun; this is the fast default gate.
    mesh = make_mesh(4)
    n, nb = 64, 16  # P*nb must divide n: 4 blocks is the 4-device minimum
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)
    L = distributed_cholesky(jnp.asarray(K), mesh=mesh, block_size=nb)
    L_ref = np.linalg.cholesky(K)
    np.testing.assert_allclose(np.asarray(L), L_ref, atol=1e-8)

    rhs = rng.standard_normal(n)
    x = distributed_chol_solve(jnp.asarray(L), jnp.asarray(rhs), mesh=mesh, block_size=nb)
    np.testing.assert_allclose(np.asarray(K @ np.asarray(x)), rhs, atol=1e-7)


def test_end_to_end_sharded_poisson():
    """Full sharded pipeline: sharded Gram -> distributed Cholesky ->
    distributed solve -> sharded posterior eval; must match the
    single-device conditioning engine.  Runs on a 4-device submesh —
    the fast default gate (8-device depth: slow tier + dryrun)."""
    mesh = make_mesh(4)
    bvp = lgt.problems.PoissonEquationDirichletProblem(
        domain=lgt.domains.asdomain([-1.0, 1.0]),
        rhs=lgt.functions.Constant((), 2.0),
        boundary_values=(0.0, 1.0),
    )
    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        2.0**2 * lgt.kernels.ExpQuad((), lengthscales=1.0),
    )
    n = 128
    X_pde = bvp.domain.uniform_grid((n,))
    Y_pde = np.asarray(bvp.pde.rhs(X_pde))

    # Single-device engine.
    post = prior.condition_on_observations(Y_pde, X=X_pde, L=bvp.pde.diffop)

    # Sharded pipeline on the same observations.
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel

    D = bvp.pde.diffop
    k_dd = apply_operator_to_kernel(
        D, apply_operator_to_kernel(D, prior.cov, argnum=1), argnum=0
    )
    # Observation noise regularizes the (numerically singular) smooth-
    # kernel Gram so both paths are well-posed and comparable.
    noise = 1e-4
    G = sharded_gram(k_dd, X_pde, mesh=mesh) + noise * jnp.eye(n)
    L = distributed_cholesky(G, mesh=mesh, block_size=32)
    w = distributed_chol_solve(L, jnp.asarray(Y_pde), mesh=mesh, block_size=32)
    dense_gram = k_dd.matrix(jnp.asarray(X_pde)) + noise * jnp.eye(n)
    w_ref = cho_solve(cholesky(dense_gram, jitter=0.0), jnp.asarray(Y_pde))
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref), rtol=1e-5, atol=1e-7)

    # Sharded posterior evaluation matches direct evaluation (one
    # with_std program covers both outputs; a separate mean-only call
    # would just compile a second near-identical shard_map program).
    xq = np.linspace(-1, 1, 53)
    mean2, std2 = sharded_posterior_eval(post, xq, mesh=mesh, with_std=True)
    np.testing.assert_allclose(np.asarray(mean2), np.asarray(post.mean(xq)), atol=1e-10)
    np.testing.assert_allclose(np.asarray(std2), np.asarray(post.std(xq)), atol=1e-10)
    # Keep the mean-only (with_std=False) program gated too.
    mean_only = sharded_posterior_eval(post, xq, mesh=mesh, with_std=False)
    np.testing.assert_allclose(np.asarray(mean_only), np.asarray(mean2), atol=1e-12)


def test_pallas_gram_interpret_matches_dense():
    """The fused closed-form Gram assembler (``terms_gram``) must agree
    with the kernel's own broadcast evaluation."""
    from linpde_gp_tpu.ops.gram import kernel_term_specs, terms_gram

    k = lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
        lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    from linpde_gp_tpu.ops import diffops
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel

    H = diffops.HeatOperator((2,), alpha=0.1)
    kk = apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, k, argnum=1), argnum=0
    )
    scale, terms = kernel_term_specs(kk)
    X0 = rng.uniform(-1, 1, (40, 2))
    X1 = rng.uniform(-1, 1, (70, 2))
    G = terms_gram(terms, jnp.asarray(X0), jnp.asarray(X1))
    dense = kk.matrix(jnp.asarray(X0), jnp.asarray(X1))
    np.testing.assert_allclose(scale * np.asarray(G), np.asarray(dense), atol=1e-12)


@pytest.mark.slow
def test_distributed_condition_arbitrary_n():
    """One-shot distributed conditioning with padding for N not divisible
    by P * block_size."""
    from linpde_gp_tpu.parallel import distributed_condition

    mesh = make_mesh(8)
    k = 2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.7)
    n = 100  # not a multiple of 8 * 8
    X = np.linspace(-1, 1, n)
    Y = np.sin(3 * X)
    noise = 1e-2  # keep the comparison well-conditioned
    w, chol = distributed_condition(
        k, X, Y, mesh=mesh, noise_variance=noise, block_size=16
    )
    dense = np.asarray(k.matrix(jnp.asarray(X))) + noise * np.eye(n)
    w_ref = np.linalg.solve(dense, Y)
    np.testing.assert_allclose(np.asarray(w), w_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.slow
@pytest.mark.parametrize("unroll", [True, False])
def test_distributed_cholesky_unroll_variants(unroll):
    mesh = make_mesh(8)
    n, nb = 128, 16
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)
    L = distributed_cholesky(jnp.asarray(K), mesh=mesh, block_size=nb, unroll=unroll)
    np.testing.assert_allclose(np.asarray(L), np.linalg.cholesky(K), atol=1e-8)


@pytest.mark.slow
def test_distributed_cholesky_cyclic_matches_dense():
    """Block-cyclic (load-balanced, exact-width GEMMs) factorization must
    equal the dense Cholesky in natural layout, and its factor must be
    drop-in for the contiguous-layout solver."""
    from linpde_gp_tpu.parallel import (
        distributed_chol_solve,
        distributed_cholesky_cyclic,
    )

    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    n, nb = 128, 16  # 8 block-rows over P=8 — full cyclic layout, small GEMMs
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    L = np.asarray(
        distributed_cholesky_cyclic(jnp.asarray(A), mesh=mesh, block_size=nb)
    )
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=0, atol=1e-8)

    b = rng.standard_normal(n)
    x = np.asarray(
        distributed_chol_solve(jnp.asarray(L), jnp.asarray(b), mesh=mesh, block_size=nb)
    )
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=0, atol=1e-8)

    # Wrap-around coverage (advisor r2): >P block-rows so devices own
    # MULTIPLE cyclic rounds (16 blocks over P=8 = 2 rounds each).
    n2, nb2 = 256, 16
    A2 = rng.standard_normal((n2, n2))
    A2 = A2 @ A2.T + n2 * np.eye(n2)
    L2 = np.asarray(
        distributed_cholesky_cyclic(jnp.asarray(A2), mesh=mesh, block_size=nb2)
    )
    np.testing.assert_allclose(L2, np.linalg.cholesky(A2), rtol=0, atol=1e-8)


@pytest.mark.slow
def test_distributed_chol_factor_incremental_extension():
    """Schur extension of a mesh-sharded factor (SURVEY §7 hard part #3):
    appending observation blocks must never refactorize the base block
    and must solve the extended system exactly."""
    from linpde_gp_tpu.parallel import (
        DistributedCholFactor,
        distributed_cholesky_cyclic,
        distributed_tri_solve,
    )

    mesh = make_mesh(8)
    rng_l = np.random.default_rng(7)
    n, nb = 128, 16
    A = rng_l.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    L = distributed_cholesky_cyclic(jnp.asarray(A), mesh=mesh, block_size=nb)

    # Multi-RHS distributed triangular solves (the extension workhorse).
    Bm = rng_l.standard_normal((n, 5))
    y = np.asarray(
        distributed_tri_solve(L, jnp.asarray(Bm), mesh=mesh, block_size=nb)
    )
    np.testing.assert_allclose(y, np.linalg.solve(np.asarray(L), Bm), atol=1e-9)

    f = DistributedCholFactor(L, mesh=mesh, block_size=nb)
    m1, m2 = 24, 17
    B1 = rng_l.standard_normal((n, m1))
    D1 = rng_l.standard_normal((m1, m1))
    D1 = D1 @ D1.T + m1 * np.eye(m1)
    f.extend(jnp.asarray(B1), jnp.asarray(D1))
    A1 = np.block([[A, B1], [B1.T, D1]])

    B2 = rng_l.standard_normal((n + m1, m2))
    D2 = rng_l.standard_normal((m2, m2))
    D2 = D2 @ D2.T + m2 * np.eye(m2)
    f.extend(jnp.asarray(B2), jnp.asarray(D2))
    A2 = np.block([[A1, B2], [B2.T, D2]])

    b = rng_l.standard_normal(n + m1 + m2)
    np.testing.assert_allclose(
        np.asarray(f.solve(jnp.asarray(b))), np.linalg.solve(A2, b), atol=1e-8
    )
    np.testing.assert_allclose(
        float(f.logdet()), np.linalg.slogdet(A2)[1], rtol=1e-12
    )


@pytest.mark.slow
def test_distributed_conditioner_incremental_batches():
    """End-to-end incremental distributed conditioning: PDE-operator
    batch factorized once, boundary batch appended by Schur extension
    (heterogeneous functionals), weights vs a dense oracle."""
    import scipy.linalg

    from linpde_gp_tpu.ops import diffops
    from linpde_gp_tpu.ops.gram import gram_matrix
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel
    from linpde_gp_tpu.parallel import DistributedConditioner

    mesh = make_mesh(8)
    k = 1.5 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.4)
    L = diffops.Derivative(2)
    kLL = apply_operator_to_kernel(
        L, apply_operator_to_kernel(L, k, argnum=1), argnum=0
    )
    kL_cross = apply_operator_to_kernel(L, k, argnum=0)

    n, m = 96, 2
    X = np.linspace(0.05, 0.95, n)
    Y = np.sin(6 * X)
    # block_size 24 with n=96 pads to 192 (4 block-rows) — exercises the
    # padding path while keeping the unrolled factorization short.
    cond = DistributedConditioner(mesh=mesh, block_size=24)
    cond.condition(kLL, X, Y, noise_variance=1e-8)

    Xb = np.array([0.0, 1.0])
    Yb = np.array([0.3, -0.2])
    w = np.asarray(cond.extend([kL_cross], k, Xb, Yb, noise_variance=1e-8))

    G11 = np.asarray(gram_matrix(kLL, jnp.asarray(X)))
    G12 = np.asarray(gram_matrix(kL_cross, jnp.asarray(X), jnp.asarray(Xb)))
    G22 = np.asarray(gram_matrix(k, jnp.asarray(Xb)))
    G = np.block(
        [[G11 + 1e-8 * np.eye(n), G12], [G12.T, G22 + 1e-8 * np.eye(m)]]
    )
    w_ref = scipy.linalg.solve(G, np.concatenate([Y, Yb]), assume_a="pos")
    np.testing.assert_allclose(w, w_ref, rtol=0, atol=1e-9 * np.abs(w_ref).max())


@pytest.mark.slow
def test_distributed_posterior_eval_mean_and_std():
    """Posterior mean/std against the MESH-SHARDED factor (multi-RHS
    distributed forward solve) must match the dense single-device
    posterior — the factor is never replicated (reference equivalent
    ``_conditional.py:223-251``)."""
    from linpde_gp_tpu.ops import diffops
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel
    from linpde_gp_tpu.parallel import DistributedConditioner

    mesh = make_mesh(8)
    k = 2.0**2 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.8)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    D = -1.0 * diffops.Laplacian(())
    kDD = apply_operator_to_kernel(
        D, apply_operator_to_kernel(D, k, argnum=1), argnum=0
    )
    kD_cross = apply_operator_to_kernel(D, k, argnum=0)  # D k (X, .)

    n = 96
    X = np.linspace(-0.95, 0.95, n)
    Y = np.full(n, 2.0)
    noise = 1e-8

    cond = DistributedConditioner(mesh=mesh, block_size=24)
    cond.condition(kDD, X, Y, noise_variance=noise, jitter=0.0)
    Xb = np.array([-1.0, 1.0])
    Yb = np.array([0.0, 1.0])
    cond.extend([kD_cross], k, Xb, Yb, noise_variance=noise, jitter=0.0)

    xq = np.linspace(-1.0, 1.0, 41)
    # Cross kernels against the QUERY evaluation functional: D k and k.
    mean, std = cond.posterior_eval([kD_cross, k], k, xq, with_std=True)

    # Dense oracle through the engine.
    post = prior.condition_on_observations(
        Y, X=X, L=D,
        b=lgt.models.randvars.Normal(np.zeros(n), noise * np.eye(n)),
    )
    post = post.condition_on_observations(
        Yb, X=Xb,
        b=lgt.models.randvars.Normal(np.zeros(2), noise * np.eye(2)),
    )
    np.testing.assert_allclose(
        np.asarray(mean), np.asarray(post.mean(xq)), rtol=0, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(std), np.asarray(post.std(xq)), rtol=1e-6, atol=1e-8
    )


def test_distributed_cholesky_2d_direct_small():
    """Fast-tier gate on the DIRECT distributed_cholesky_2d entry point
    (not only through the auto-router)."""
    from linpde_gp_tpu.parallel import distributed_cholesky_2d

    mesh = make_mesh(8)  # 2 x 4
    rng_l = np.random.default_rng(21)
    n, nb = 64, 16  # 4 block-columns: one cyclic round over the mesh cols
    A = rng_l.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    L = np.asarray(
        distributed_cholesky_2d(jnp.asarray(A), mesh=mesh, block_size=nb, jitter=0.0)
    )
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=0, atol=1e-8)


@pytest.mark.slow
def test_distributed_cholesky_2d_matches_dense():
    """2-D block-cyclic (ScaLAPACK-layout) factorization over a 2x4 mesh
    must equal the dense Cholesky in natural layout (the
    O(n^2/sqrt(P))-communication variant)."""
    from linpde_gp_tpu.parallel import distributed_cholesky_2d

    mesh = make_mesh(8)  # 2 x 4 virtual CPU devices
    rng_l = np.random.default_rng(9)
    n, nb = 128, 16  # 8 block-columns: 2 cyclic rounds over the 4 mesh cols
    A = rng_l.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    L = np.asarray(
        distributed_cholesky_2d(jnp.asarray(A), mesh=mesh, block_size=nb, jitter=0.0)
    )
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=0, atol=1e-8)

    # The factor drops into the 1-D row-sharded solver unchanged.
    b = rng_l.standard_normal(n)
    x = np.asarray(
        distributed_chol_solve(jnp.asarray(L), jnp.asarray(b), mesh=mesh, block_size=16)
    )
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=0, atol=1e-8)


def test_distributed_cholesky_2d_masked_many_blocks():
    """Masked fori_loop 2-D body above the 128-block unroll cap
    (the north-star-size regime, e.g. N=1e5/nb=256 = 391 block-columns,
    must route 2-D)."""
    from linpde_gp_tpu.parallel.solve import _factorize

    mesh = make_mesh(8)  # 2 x 4
    rng_l = np.random.default_rng(11)
    nb = 2
    n = nb * 4 * 33  # 264 -> 132 block-columns > 128
    A = rng_l.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    # One factorization through the AUTO-ROUTER (above 128 block-columns
    # it must pick the masked fori_loop 2-D layout — it used to fall back
    # to the contiguous 1-D variant) checked against the dense oracle;
    # a second direct distributed_cholesky_2d call would only re-compile
    # the same masked program.
    lgt.config.set(cholesky_jitter=0.0)
    L = np.asarray(_factorize(jnp.asarray(A), mesh=mesh, block_size=nb))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=0, atol=1e-8)


def test_distributed_gram_matvec_matches_dense():
    """Row-sharded streaming matvec (the mesh story for the gram-free
    north-star path)."""
    from linpde_gp_tpu.ops.gram import kernel_term_specs
    from linpde_gp_tpu.parallel import distributed_gram_matvec

    mesh = make_mesh(8)
    k = 1.7 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=0.8),
        lgt.kernels.Matern((), nu=2.5, lengthscales=1.1),
    )
    spec = kernel_term_specs(k)
    rng_l = np.random.default_rng(21)
    n0, n1 = 203, 117  # deliberately NOT multiples of 8
    X0 = rng_l.uniform(-1, 1, (n0, 2))
    X1 = rng_l.uniform(-1, 1, (n1, 2))
    v = rng_l.standard_normal(n1)
    out = np.asarray(
        distributed_gram_matvec(spec, X0, X1, jnp.asarray(v), mesh=mesh)
    )
    ref = np.asarray(k.matrix(jnp.asarray(X0), jnp.asarray(X1))) @ v
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)


@pytest.mark.slow
def test_distributed_iterative_matches_single_device():
    """Mesh PCG (sharded streaming matvec + sharded Nystrom) must agree
    with the single-device IterativeGPRegressor to CG tolerance."""
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops
    from linpde_gp_tpu.parallel import DistributedIterativeGPRegressor

    mesh = make_mesh(8)
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.3 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    rng_l = np.random.default_rng(22)
    n, nq = 1100, 77  # n NOT a multiple of 8: exercises row padding
    X = np.stack(
        [rng_l.uniform(0, 5, n), rng_l.uniform(-1, 1, n)], axis=-1
    )
    Y = rng_l.standard_normal(n)
    Xq = np.stack(
        [rng_l.uniform(0, 5, nq), rng_l.uniform(-1, 1, nq)], axis=-1
    )

    kw = dict(L=H, noise_variance=1e-4, tol=1e-10, maxiter=3000,
              precond_rank=64)
    single = IterativeGPRegressor(prior, X, Y, **kw)
    dist = DistributedIterativeGPRegressor(prior, X, Y, mesh=mesh, **kw)

    w_s = np.asarray(single.representer_weights)
    w_d = np.asarray(dist.representer_weights)
    assert dist.solve_info[1] < 1e-9
    np.testing.assert_allclose(w_d, w_s, rtol=0, atol=1e-6 * np.abs(w_s).max())

    m_s = np.asarray(single.mean(jnp.asarray(Xq)))
    m_d = np.asarray(dist.mean(jnp.asarray(Xq)))
    np.testing.assert_allclose(m_d, m_s, rtol=0, atol=1e-8)

    # Pointwise variance: mesh blocked multi-RHS PCG vs the single-device
    # pcg_block path.  block_size=32 forces several
    # query blocks including a padded last block.
    v_s = np.asarray(single.var(jnp.asarray(Xq)))
    v_d = np.asarray(dist.var(jnp.asarray(Xq), block_size=32))
    np.testing.assert_allclose(v_d, v_s, rtol=0, atol=1e-8)


@pytest.mark.slow
def test_distributed_iterative_banded_wendland():
    """Compact-support routing on the mesh: the distributed regressor
    internally sorts points and runs the banded schedule per device;
    results must match the single-device path in the CALLER's point
    order."""
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops.kernels.wendland import WendlandCovarianceFunction
    from linpde_gp_tpu.parallel import DistributedIterativeGPRegressor

    mesh = make_mesh(8)
    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        2.0 * WendlandCovarianceFunction((), k=2, lengthscales=0.15),
    )
    rng_l = np.random.default_rng(29)
    n = 420  # NOT a multiple of 8; unsorted input order
    X = rng_l.uniform(0.0, 1.0, n)
    Y = np.sin(7 * X)
    kw = dict(noise_variance=1e-6, tol=1e-10, maxiter=1200, precond_rank=64)
    prev_tile = lgt.config.band_tile
    lgt.config.set(band_tile=64)  # make the band non-trivial at n=420
    try:
        single = IterativeGPRegressor(prior, X, Y, **kw)
        dist = DistributedIterativeGPRegressor(prior, X, Y, mesh=mesh, **kw)
        assert dist._band_info() is not None, "banded schedule not engaged"
        w_s = np.asarray(single.representer_weights)
        w_d = np.asarray(dist.representer_weights)
        np.testing.assert_allclose(
            w_d, w_s, rtol=0, atol=1e-6 * np.abs(w_s).max()
        )
        xq = np.linspace(0.0, 1.0, 21)
        np.testing.assert_allclose(
            np.asarray(dist.mean(jnp.asarray(xq))),
            np.asarray(single.mean(jnp.asarray(xq))),
            rtol=0, atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(dist.var(jnp.asarray(xq), block_size=16)),
            np.asarray(single.var(jnp.asarray(xq))),
            rtol=0, atol=1e-8,
        )
    finally:
        lgt.config.set(band_tile=prev_tile)


def test_distributed_iterative_no_preconditioner():
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.parallel import DistributedIterativeGPRegressor

    mesh = make_mesh(8)
    prior = lgt.GaussianProcess(
        lgt.functions.Zero(()),
        2.0 * lgt.kernels.Matern((), nu=2.5, lengthscales=0.6),
    )
    rng_l = np.random.default_rng(23)
    n = 96
    X = np.sort(rng_l.uniform(-1, 1, n))
    Y = np.sin(3 * X)
    kw = dict(noise_variance=1e-6, tol=1e-12, maxiter=2000, precond_rank=0)
    single = IterativeGPRegressor(prior, X, Y, **kw)
    dist = DistributedIterativeGPRegressor(prior, X, Y, mesh=mesh, **kw)
    xq = np.linspace(-1, 1, 33)
    np.testing.assert_allclose(
        np.asarray(dist.mean(jnp.asarray(xq))),
        np.asarray(single.mean(jnp.asarray(xq))),
        rtol=0, atol=1e-8,
    )
