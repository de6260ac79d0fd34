"""Benchmark: the gram-free heat conditioning solve at N=1e5 on one GPU.

Conditions ``IterativeGPRegressor`` (float64) on N heat-operator
collocation observations plus 192 IC/BC anchors — the problem of
``chip_smoke.py`` phase 3 — and times the representer-weight solve:
once cold (compilation and the rank-4096 Nystrom build included) and
once warm (``refit``: the CG solve alone).  Every CG iteration streams
the operator-transformed Gram ``H k H* (X, X)`` through the kernel
reduction (O(N^2) pair evaluations, O(N) memory).

    python bench.py [--n 100000]

Prints one JSON line with the times, the CG iterations and the device.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=100_000)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from linpde_gp_tpu import backend
    from linpde_gp_tpu.models.iterative import IterativeGPRegressor

    import chip_smoke

    backend.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    p = chip_smoke.heat_solve_problem(np.random.default_rng(0), args.n)
    tol = 1e-5
    t0 = time.perf_counter()
    reg = IterativeGPRegressor(
        p["prior"], p["X"], p["Y"], L=p["H"], noise_variance=p["noise"],
        tol=tol, maxiter=512, precond_rank=min(4096, args.n // 4),
        anchor_X=p["X_anchor"], anchor_Y=p["Y_anchor"], anchor_noise=1e-12,
    )
    jax.block_until_ready(reg.representer_weights)
    t_cold = time.perf_counter() - t0
    reg.refit(p["Y"], anchor_Y=p["Y_anchor"])
    t0 = time.perf_counter()
    jax.block_until_ready(reg.representer_weights)
    t_warm = time.perf_counter() - t0
    iters, relres = reg.solve_info
    if not relres <= tol:
        raise SystemExit(f"bench: CG did not converge (relres={relres:.3e})")
    print(json.dumps({
        "metric": f"heat_LkL_pcg_condition_n{args.n}_f64",
        "value": t_warm,
        "unit": "s",
        "cold_s": t_cold,
        "cg_iterations": iters,
        "relres": relres,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
