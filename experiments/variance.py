"""Posterior VARIANCE at the north-star scale (N=1e5).

``IterativeGPRegressor.var`` runs one blocked multi-RHS CG per query
block (``pcg_block``, ``ops/linalg/pcg.py``): one shared (n, bs)
streaming mat-mat per iteration for ``bs`` query columns.

Quality gates (the dense N=1e5 oracle cannot exist — 40 GB Gram):
- CPU tier: the same ``var`` path is asserted against the dense oracle
  in ``tests/test_pcg_r5.py`` / ``tests/test_conditioning.py``;
- here: two independent block partitions (bs and bs//2 — different
  Krylov spaces per column group) must agree to ~CG tolerance, and the
  variance must be positive and bounded by the prior variance.

Usage:  python experiments/variance.py           (GPU, N=1e5)
        VT_N=32768 VT_NQ=1024 python experiments/variance.py
On the CPU it runs a float64 miniature (N=2048).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(f"# variance: {msg}", file=sys.stderr, flush=True)


def main():
    from common import setup

    lgt = setup()
    import jax
    from linpde_gp_tpu import backend

    on_gpu = backend.platform() == "gpu"

    import jax.numpy as jnp

    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops import diffops

    n = int(os.environ.get("VT_N", 100_000 if on_gpu else 2048))
    nq = int(os.environ.get("VT_NQ", 2048 if on_gpu else 128))
    bs = int(os.environ.get("VT_BS", 256 if on_gpu else 32))
    rank = int(os.environ.get("VT_RANK", 8192 if on_gpu else 128))
    noise_rel = float(os.environ.get("VT_NOISE", 1e-3))
    tol = float(os.environ.get("VT_TOL", 1e-5 if on_gpu else 1e-8))
    dtype = np.float64

    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)

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

    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1).astype(dtype)
    Y = rng.standard_normal(n).astype(dtype)
    Xq = np.stack(
        [rng.uniform(0.0, 5.0, nq), rng.uniform(-1.0, 1.0, nq)], -1
    ).astype(dtype)

    _log(f"n={n} nq={nq} bs={bs} rank={rank} noise={noise_variance:.3e}")
    t0 = time.perf_counter()
    reg = IterativeGPRegressor(
        prior, X, Y, L=H,
        noise_variance=noise_variance, tol=tol, maxiter=512,
        precond_rank=min(rank, n // 4),
    )
    w = np.asarray(reg.representer_weights[:4])
    assert np.all(np.isfinite(w))
    t_cond = time.perf_counter() - t0
    iters, relres = reg.solve_info
    _log(f"conditioning: {t_cond:.1f} s, iters={iters} relres={relres:.3e}")

    t0 = time.perf_counter()
    var = np.asarray(reg.var(jnp.asarray(Xq), block_size=bs), np.float64)
    t_var = time.perf_counter() - t0
    _log(f"variance at nq={nq} (bs={bs}): {t_var:.1f} s "
         f"({t_var / max(nq, 1) * 1e3:.1f} ms/query)")

    prior_var = float(prior.cov(jnp.asarray(Xq[:1]))[0])
    assert np.all(var >= 0.0), "negative posterior variance"
    assert np.all(var <= prior_var * (1.0 + 1e-3)), "variance above prior"

    # Consistency gate: an independent block partition must agree.
    nq_chk = min(nq, 4 * bs)
    t0 = time.perf_counter()
    var_chk = np.asarray(
        reg.var(jnp.asarray(Xq[:nq_chk]), block_size=bs // 2), np.float64
    )
    t_chk = time.perf_counter() - t0
    rel = np.max(np.abs(var_chk - var[:nq_chk])) / max(np.max(var[:nq_chk]), 1e-12)
    _log(f"block-partition consistency on {nq_chk} queries: "
         f"rel diff {rel:.3e} ({t_chk:.1f} s)")

    print(json.dumps({
        "experiment": "variance_large_scale",
        "n": n, "nq": nq, "block_size": bs, "rank": min(rank, n // 4),
        "noise_variance": noise_variance,
        "condition_s": round(t_cond, 2), "pcg_iters": int(iters),
        "variance_s": round(t_var, 2),
        "variance_s_per_query_ms": round(t_var / max(nq, 1) * 1e3, 2),
        "partition_consistency_rel": rel,
        "std_range": [float(np.sqrt(var.min())), float(np.sqrt(var.max()))],
        "backend": backend.platform(),
    }))


if __name__ == "__main__":
    main()
