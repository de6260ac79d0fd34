"""Compensated sum-of-Kronecker grid matvec (ops/kron_ff.py).

The plain-f32 Kronecker evaluation of the heat ``H k H*`` closed form
carries ~600*eps32 term-cancellation error — measured 7e-2 relative at a
(200, 100) grid, 140x a 1e-3 nugget — enough to stall a float32
grid-mode solve at relres 0.34.  These tests pin the compensated path's
accuracy and its engagement in the regressor.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import linpde_gp_tpu as lgt
from linpde_gp_tpu.models.domains.grid import TensorProductGrid
from linpde_gp_tpu.ops import diffops
from linpde_gp_tpu.ops.kron_ff import KronFFMatvec
from linpde_gp_tpu.ops.gram import kernel_term_specs
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel


def _heat_spec():
    prior_cov = 1.0 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
        lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    k_hh = apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, prior_cov, argnum=1), argnum=0
    )
    return k_hh, kernel_term_specs(k_hh)


def test_kron_ff_matches_f64_oracle():
    k_hh, spec = _heat_spec()
    nt, nx = 96, 48
    tg = np.linspace(1e-3, 5.0, nt)
    xg = np.linspace(-1.0, 1.0, nx + 2)[1:-1]
    X64 = TensorProductGrid(tg, xg)
    lin64 = k_hh.linop(X64)

    # TRUE-f32 plain reference built in numpy (the jax linop silently
    # promotes under the x64 test config): f32 factor tables, f32 GEMMs.
    from linpde_gp_tpu.ops.kron_ff import eval_factor_np

    scale, terms = spec
    tables32 = []
    d_t = tg[:, None] - tg[None, :]
    d_x = xg[:, None] - xg[None, :]
    for coeff, fs in terms:
        A = (float(scale) * float(coeff) * eval_factor_np(fs[0], d_t)).astype(
            np.float32
        )
        B = eval_factor_np(fs[1], d_x).astype(np.float32)
        tables32.append((A, B))

    def plain_f32(v):
        V = v.astype(np.float32).reshape(nt, nx)
        acc = np.zeros((nt, nx), np.float32)
        for A, B in tables32:
            acc = acc + A @ V @ B.T
        return acc.reshape(-1)

    mv = KronFFMatvec(spec, (tg, xg))
    rng = np.random.default_rng(0)
    n = nt * nx
    worst_ff, worst_plain = 0.0, 0.0
    for _ in range(4):
        v = rng.standard_normal(n)
        y64 = np.asarray(lin64 @ jnp.asarray(v), np.float64)
        y32 = plain_f32(v).astype(np.float64)
        yff = np.asarray(mv(jnp.asarray(v, jnp.float32)), np.float64)
        worst_ff = max(worst_ff, np.linalg.norm(yff - y64) / np.linalg.norm(v))
        worst_plain = max(
            worst_plain, np.linalg.norm(y32 - y64) / np.linalg.norm(v)
        )
    # The compensated path must stay far below a 1e-3-relative nugget
    # (diag ~ 0.5 -> 5e-4 abs) and never lose to the honest-f32 GEMM
    # reference.  (The worst REAL hazard is platform-specific: a
    # DEFAULT-precision float32 einsum may accumulate at bf16/TF32
    # fidelity — 2.4e-3 relative on a 96-contraction, enough to stall
    # a grid solve; ops/linalg/linops.py pins HIGHEST explicitly.)
    assert worst_ff < 1.05 * worst_plain + 1e-7
    assert worst_ff < 5e-5

    # Matrix right-hand sides go through the same path.
    V = rng.standard_normal((n, 3)).astype(np.float32)
    Y = np.asarray(mv(jnp.asarray(V)), np.float64)
    Y64 = np.asarray(lin64 @ jnp.asarray(V, jnp.float64), np.float64)
    assert np.linalg.norm(Y - Y64) / np.linalg.norm(V) < 1e-4


def test_regressor_engages_kron_ff_on_grids():
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor

    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    tg = np.linspace(1e-3, 5.0, 24).astype(np.float32)
    xg = np.linspace(-0.9, 0.9, 16).astype(np.float32)
    X = TensorProductGrid(tg, xg)
    Y = np.zeros(24 * 16, np.float32)
    reg = IterativeGPRegressor(
        prior, X, Y, L=H, noise_variance=1e-3, compensated=True,
        device_cg=True, precond_build="device", precond_rank=64,
        tol=1e-5, maxiter=400,
    )
    assert reg._kron_ff is not None
    # And the f32 compensated grid solve converges where the plain-f32
    # operator error would forbid it.
    rng = np.random.default_rng(1)
    reg.Y = jnp.asarray(rng.standard_normal(24 * 16), jnp.float32)
    _ = reg.representer_weights
    it, rr = reg.solve_info
    assert rr <= 1e-4
