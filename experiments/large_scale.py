"""North-star accuracy: heat-1D conditioned at N=1e5 collocation points,
posterior RMSE vs the ANALYTIC sine-series solution.

Replicates the reference's heat experiment (``0002_heat_1d.ipynb``;
analytic solution ``problems/pde/_heat.py:96``) at gram-free scale:
space-time Matérn TensorProduct prior, N heat-operator collocation
observations (zero RHS), IC + BC point observations as the ANCHOR batch
(block Schur elimination, ``models/iterative.py``), float64.  The problem
is ``chip_smoke.heat_solve_problem`` (phase 3 of ``chip_smoke.py``).

Usage:  python experiments/large_scale.py            (GPU, N=1e5)
        LS_N=32768 python experiments/large_scale.py (smaller N)
On the CPU it runs a miniature (N=2048).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(f"# large_scale: {msg}", file=sys.stderr, flush=True)


def main():
    from common import setup

    setup()
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from linpde_gp_tpu import backend
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor

    on_gpu = backend.platform() == "gpu"
    n_pde = int(os.environ.get("LS_N", 100_000 if on_gpu else 2048))
    nq = int(os.environ.get("LS_NQ", 8192 if on_gpu else 512))
    rank = int(os.environ.get("LS_RANK", 4096 if on_gpu else 256))
    tol = float(os.environ.get("LS_TOL", 1e-5))
    maxiter = int(os.environ.get("LS_MAXITER", 512))

    rng = np.random.default_rng(0)
    p = chip_smoke.heat_solve_problem(rng, n_pde)
    _log(
        f"n_pde={n_pde} anchors={p['X_anchor'].shape[0]} nq={nq} "
        f"noise={p['noise']:.3e} rank={rank}"
    )

    t0 = time.perf_counter()
    reg = IterativeGPRegressor(
        p["prior"], p["X"], p["Y"], L=p["H"],
        noise_variance=p["noise"], tol=tol, maxiter=maxiter,
        precond_rank=min(rank, n_pde // 4),
        anchor_X=p["X_anchor"], anchor_Y=p["Y_anchor"], anchor_noise=1e-12,
    )
    w = np.asarray(jax.block_until_ready(reg.representer_weights))
    t_condition = time.perf_counter() - t0
    assert np.all(np.isfinite(w)), "non-finite representer weights"
    iters, relres = reg.solve_info
    _log(f"conditioned in {t_condition:.1f} s (incl. compile): "
         f"iters={iters} relres={relres:.3e}")

    # Posterior mean on random query points vs the analytic solution.
    Xq = chip_smoke._space_time_points(rng, nq)
    t0 = time.perf_counter()
    mean_q = np.asarray(jax.block_until_ready(reg.mean(jnp.asarray(Xq))))
    t_eval = time.perf_counter() - t0
    truth = np.asarray(p["ibvp"].solution(jnp.asarray(Xq))).reshape(-1)
    err = mean_q - truth
    rmse = float(np.sqrt(np.mean(err**2)))
    max_err = float(np.max(np.abs(err)))
    _log(f"posterior mean at nq={nq}: {t_eval:.1f} s; "
         f"RMSE={rmse:.3e} max|err|={max_err:.3e}")

    print(
        json.dumps(
            {
                "experiment": "heat1d_accuracy_large_scale",
                "n_pde": n_pde,
                "n_anchor": int(p["X_anchor"].shape[0]),
                "noise_variance": p["noise"],
                "pcg_iters": iters,
                "pcg_relres": relres,
                "condition_s": t_condition,
                "rmse_vs_analytic": rmse,
                "max_err_vs_analytic": max_err,
                "backend": backend.platform(),
            }
        )
    )


if __name__ == "__main__":
    main()
