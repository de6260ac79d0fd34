"""Banded compact-support matvec: the O(N·band) win.

Wendland kernels vanish beyond their support radius; the banded schedule
(``ops/gram.make_banded_matvec``) visits only the column
tiles inside the window — exact, not approximate.  The reference routes
Wendland through the same dense KeOps reduction as everything else
(``covfuncs/_wendland.py:23-29``) and never exploits the sparsity.

Measures, at N=1e5 on the GPU (N=4096 on the CPU): dense streaming
matvec vs banded matvec steady-state wall-clock + the band fraction, and
a full banded conditioning (IterativeGPRegressor auto-routes the banded
path).

Usage:  python experiments/wendland_banded.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(f"# wendland_banded: {msg}", file=sys.stderr, flush=True)


def main():
    from common import setup

    lgt = setup()
    import jax
    from linpde_gp_tpu import backend

    on_gpu = backend.platform() == "gpu"

    import jax.numpy as jnp

    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.ops.kernels.wendland import WendlandCovarianceFunction
    from linpde_gp_tpu.ops.gram import (
        kernel_term_specs,
        gram_matvec,
        make_banded_matvec,
    )

    n = int(os.environ.get("WB_N", 100_000 if on_gpu else 4096))
    ell = float(os.environ.get("WB_ELL", 0.05))  # support radius
    dtype = np.float64

    # Quasi-uniform 1-D points on [0, 1]: support 0.05 -> ~5% band.
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0.0, 1.0, n)).astype(dtype)
    v = rng.standard_normal(n).astype(dtype)

    k = 2.0 * WendlandCovarianceFunction((), k=2, lengthscales=ell)
    spec = kernel_term_specs(k)
    scale, terms = spec

    banded = make_banded_matvec(spec, X, X)
    frac = banded.band_tiles / banded.total_tiles
    _log(f"n={n} support={ell}: band {banded.band_tiles}/{banded.total_tiles} "
         f"tiles ({100 * frac:.1f}%)")

    x_dev = jnp.asarray(X)
    v_dev = jnp.asarray(v)

    def timed(fn, *args):
        out = jax.block_until_ready(fn(*args))
        times = []
        for _i in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
        return min(times), out

    dense_fn = jax.jit(lambda x, w: gram_matvec(spec, x, x, w))
    t_dense, out_dense = timed(dense_fn, x_dev, v_dev)
    _log(f"dense streaming matvec: {t_dense * 1e3:.1f} ms "
         f"({n * n / t_dense / 1e9:.1f} G pair/s)")

    banded_jit = jax.jit(banded)
    t_band, out_band = timed(banded_jit, v_dev)
    _log(f"banded matvec: {t_band * 1e3:.1f} ms ({t_dense / t_band:.1f}x faster)")

    err = float(
        np.max(np.abs(np.asarray(out_band) - np.asarray(out_dense)))
        / max(float(np.max(np.abs(np.asarray(out_dense)))), 1e-30)
    )
    _log(f"banded vs dense agreement: rel max err {err:.2e}")

    # Full conditioning through the auto-routed banded path.
    Y = np.sin(8.0 * X).astype(dtype)
    prior = lgt.GaussianProcess(lgt.functions.Zero(()), k)
    t0 = time.perf_counter()
    reg = IterativeGPRegressor(
        prior, X, Y, noise_variance=1e-3 if on_gpu else 1e-8,
        tol=1e-5 if on_gpu else 1e-10, maxiter=512,
        precond_rank=1024 if on_gpu else 128,
    )
    _ = np.asarray(reg.representer_weights[:4])
    t_cond = time.perf_counter() - t0
    iters, relres = reg.solve_info
    routed = reg._banded is not None
    _log(f"banded conditioning: {t_cond:.1f} s (incl. compile), iters={iters} "
         f"relres={relres:.2e} banded_routed={routed}")

    print(json.dumps({
        "experiment": "wendland_banded",
        "n": n,
        "support_radius": ell,
        "band_fraction": frac,
        "dense_matvec_s": t_dense,
        "banded_matvec_s": t_band,
        "speedup_x": t_dense / t_band,
        "agreement_rel_err": err,
        "condition_s_incl_compile": round(t_cond, 2),
        "pcg_iters": iters,
        "banded_routed": routed,
        "backend": backend.platform(),
    }))


if __name__ == "__main__":
    main()
