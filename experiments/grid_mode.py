"""Grid-mode north star: heat-1D conditioned on a (500 x 200) = 1e5-point
TensorProductGrid in single-digit seconds.

The reference's own heat experiment collocates on a tensor-product grid
(``experiments/0002_heat_1d.ipynb``, ``N_pde=(100, 20)``) and keeps
Kronecker structure for the transformed Gram
(``diffops/_tensor_product.py:140-156``).  Here the same structure feeds
the ITERATIVE solver: on a ``TensorProductGrid`` every Gram matvec is a
sum of Kronecker products — O(N * (n_t + n_x)) work instead of the
O(N^2) streaming reduction, ~7e7 vs 1e10 pair-ops at N=1e5 — so the
honest-noise north-star conditioning runs at device-arithmetic speed:
the f32 resolution-floored hybrid Nystrom preconditioner
(``ops/linalg/pcg.py``) plus the device-state float-float CG
(``pcg_ff``) keep the iteration count and the per-iteration dispatch
overhead both small.

Usage:  python experiments/grid_mode.py             (GPU, (500,200))
        GM_NT=100 GM_NX=20 python experiments/grid_mode.py
        GM_X64=0 python experiments/grid_mode.py   (float32: compensated
                                                   matvec, device-state CG)
On the CPU it runs a miniature (64 x 32).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(f"# grid_mode: {msg}", file=sys.stderr, flush=True)


def main():
    from common import setup

    x64 = bool(int(os.environ.get("GM_X64", 1)))
    lgt = setup(x64)
    import jax
    from linpde_gp_tpu import backend

    on_gpu = backend.platform() == "gpu"

    import jax.numpy as jnp

    from linpde_gp_tpu.models.domains.grid import TensorProductGrid
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor

    n_t = int(os.environ.get("GM_NT", 500 if on_gpu else 64))
    n_x = int(os.environ.get("GM_NX", 200 if on_gpu else 32))
    n_ic = int(os.environ.get("GM_N_IC", 96 if on_gpu else 48))
    n_bc = int(os.environ.get("GM_N_BC", 48 if on_gpu else 24))
    nq = int(os.environ.get("GM_NQ", 8192 if on_gpu else 512))
    noise_rel = float(os.environ.get("GM_NOISE", 1e-3 if on_gpu else 1e-6))
    # A float32 anchor Cholesky breaks down near eps32 * ||A11|| * O(n1).
    anchor_noise = float(os.environ.get("GM_ANCHOR_NOISE", 1e-12 if x64 else 1e-5))
    rank = int(os.environ.get("GM_RANK", 2048 if on_gpu else 256))
    tol = float(os.environ.get("GM_TOL", 1e-5 if on_gpu else 1e-6))
    maxiter = int(os.environ.get("GM_MAXITER", 512 if on_gpu else 4000))
    f32 = not x64
    dtype = np.float32 if f32 else np.float64
    device_cg = bool(int(os.environ.get("GM_DEVICE_CG", 1 if f32 else 0)))
    compensated = bool(int(os.environ.get("GM_COMP", 1 if f32 else 0)))
    build = os.environ.get("GM_BUILD", "device" if f32 else "auto")

    spatial_domain = lgt.domains.asdomain([-1.0, 1.0])
    ibvp = lgt.problems.HeatEquationDirichletProblem(
        t0=0.0,
        T=5.0,
        spatial_domain=spatial_domain,
        alpha=0.1,
        initial_values=lgt.functions.TruncatedSineSeries(
            spatial_domain, coefficients=[1.0]
        ),
    )
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    H = ibvp.pde.diffop
    u_star = ibvp.solution

    # PDE collocation on a TensorProductGrid (interior inset like the
    # reference's config) — the factor structure is what the solver's
    # sum-of-Kronecker matvec keys on.
    tg = np.linspace(0.0 + 1e-3, 5.0, n_t).astype(dtype)
    xg = np.linspace(-1.0, 1.0, n_x + 2)[1:-1].astype(dtype)
    X_pde = TensorProductGrid(tg, xg)
    n_pde = n_t * n_x
    Y_pde = np.zeros(n_pde, dtype)

    X_ic = np.stack([np.zeros(n_ic), np.linspace(-1.0, 1.0, n_ic)], axis=-1)
    X_bc = np.concatenate(
        [
            np.stack([np.linspace(0.0, 5.0, n_bc), np.full(n_bc, -1.0)], axis=-1),
            np.stack([np.linspace(0.0, 5.0, n_bc), np.full(n_bc, 1.0)], axis=-1),
        ]
    )
    X_anchor = np.concatenate([X_ic, X_bc]).astype(dtype)
    Y_anchor = np.asarray(
        u_star(jnp.asarray(X_anchor))
    ).astype(dtype)

    from linpde_gp_tpu.ops.gram import kernel_term_specs
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel

    k_hh = apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, prior.cov, argnum=1), argnum=0
    )
    scale, terms = kernel_term_specs(k_hh)

    def _f0(f):
        kind, s, poly, parity, pref = f
        return 0.0 if parity else pref * poly[0]

    diag = scale * sum(
        float(c) * float(np.prod([_f0(f) for f in fs])) for c, fs in terms
    )
    noise_variance = noise_rel * diag

    _log(
        f"grid=({n_t},{n_x}) N={n_pde} anchors={X_anchor.shape[0]} "
        f"noise={noise_variance:.3e} rank={rank}"
    )

    t0 = time.perf_counter()
    reg = IterativeGPRegressor(
        prior, X_pde, Y_pde, L=H,
        noise_variance=noise_variance,
        tol=tol, maxiter=maxiter,
        precond_rank=min(rank, n_pde // 4),
        compensated=compensated,
        host_cg=False,
        device_cg=device_cg,
        precond_build=build,
        anchor_X=X_anchor, anchor_Y=Y_anchor, anchor_noise=anchor_noise,
    )
    assert reg._gram_linop is not None, "sum-of-Kronecker routing not engaged"
    w = np.asarray(reg.representer_weights[:4])
    assert np.all(np.isfinite(w)), "non-finite representer weights"
    t_first = time.perf_counter() - t0
    iters, relres = reg.solve_info
    _log(f"conditioning (incl. compile): {t_first:.2f} s, "
         f"iters={iters} relres={relres:.3e}")

    # Steady-state repeat: a fresh regressor re-runs build + solve from
    # the warm compile caches.
    t0 = time.perf_counter()
    reg2 = IterativeGPRegressor(
        prior, X_pde, Y_pde, L=H,
        noise_variance=noise_variance,
        tol=tol, maxiter=maxiter,
        precond_rank=min(rank, n_pde // 4),
        compensated=compensated,
        host_cg=False,
        device_cg=device_cg,
        precond_build=build,
        anchor_X=X_anchor, anchor_Y=Y_anchor, anchor_noise=anchor_noise,
    )
    _ = np.asarray(reg2.representer_weights[:4])
    t_steady = time.perf_counter() - t0
    iters2, relres2 = reg2.solve_info
    _log(f"steady-state conditioning: {t_steady:.2f} s, "
         f"iters={iters2} relres={relres2:.3e}")

    # Repeated-solve path: same geometry, new data — every factor and
    # compiled program is reused, so this is one CG solve's wall-clock
    # (the production serving cost per new observation vector).
    t0 = time.perf_counter()
    _ = np.asarray(reg2.refit(Y_pde, anchor_Y=Y_anchor).representer_weights[:4])
    t_refit = time.perf_counter() - t0
    iters3, relres3 = reg2.solve_info
    _log(f"refit (cached factors/programs): {t_refit:.2f} s, "
         f"iters={iters3} relres={relres3:.3e}")

    # Posterior accuracy vs the analytic solution on held-out points.
    rng = np.random.default_rng(7)
    Xq = np.stack(
        [rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], axis=-1
    ).astype(dtype)
    t0 = time.perf_counter()
    mu = np.asarray(reg2.mean(jnp.asarray(Xq)))
    t_eval = time.perf_counter() - t0
    truth = np.asarray(u_star(jnp.asarray(Xq, jnp.float64))).astype(np.float64)
    rmse = float(np.sqrt(np.mean((mu - truth) ** 2)))
    max_err = float(np.max(np.abs(mu - truth)))
    _log(f"posterior eval at nq={nq}: {t_eval:.2f} s; RMSE vs analytic: {rmse:.3e}")

    print(json.dumps({
        "experiment": "grid_mode_heat1d",
        "grid": [n_t, n_x],
        "n_pde": n_pde,
        "n_anchor": int(X_anchor.shape[0]),
        "noise_variance": noise_variance,
        "condition_first_s": round(t_first, 3),
        "condition_steady_s": round(t_steady, 3),
        "refit_s": round(t_refit, 3),
        "pcg_iters": int(iters2),
        "pcg_relres": float(relres2),
        "posterior_eval_s": round(t_eval, 3),
        "rmse_vs_analytic": rmse,
        "max_err_vs_analytic": max_err,
        "backend": backend.platform(),
    }))


if __name__ == "__main__":
    main()
