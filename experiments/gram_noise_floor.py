"""Measure the float32 streaming-Gram noise floor: plain vs compensated.

1. Entry accuracy at n=4096: computed float32 Gram (plain vs
   compensated float-float) against the float64 host oracle —
   max per-entry error AND the spectral norm ``||E||_2`` of the error
   matrix (power iteration on the host).  The coherent part is what
   drives ``lambda_min`` negative: plain f32 measured at
   ``||E||_2 ~ 1e-6 * n * k(0)``; compensated must cut it by >=1e3.
2. Pair throughput at n=32768: steady-state streaming matvec wall-clock
   in both modes (``xla_gram_matvec``, the device route).

Usage: ``python experiments/gram_noise_floor.py`` (GPU; on the CPU it
reports the same table at small n).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(f"# noise_floor: {msg}", file=sys.stderr, flush=True)


def _f64_gram_host(scale, terms, X):
    """Float64 oracle on the host (numpy), via the collapsed groups."""
    from linpde_gp_tpu.ops.gram import _collapse_terms

    groups = _collapse_terms(tuple(terms))
    X = X.astype(np.float64)
    n = X.shape[0]
    acc = np.zeros((n, n))
    d_cache = {}
    t_cache = {}
    e_cache = {}

    def d(i):
        if i not in d_cache:
            d_cache[i] = X[:, None, i] - X[None, :, i]
        return d_cache[i]

    for dims_key, parity, C in groups:
        ts, env = [], None
        for i, (kind, s) in enumerate(dims_key):
            tk = (i, kind, s)
            if tk not in t_cache:
                if kind == "matern":
                    t = s * np.abs(d(i))
                    e = np.exp(-t)
                elif kind == "wendland":
                    t = s * np.abs(d(i))
                    e = (t <= 1.0).astype(np.float64)
                else:
                    t = s * d(i)
                    e = np.exp(-(t * t))
                t_cache[tk], e_cache[tk] = t, e
            ts.append(t_cache[tk])
            env = e_cache[tk] if env is None else env * e_cache[tk]

        def horner(Cc, axis=0):
            if axis == len(ts) - 1:
                r = np.full_like(ts[axis], Cc[-1])
                for c in reversed(Cc[:-1]):
                    r = r * ts[axis] + c
                return r
            subs = [horner(sub, axis + 1) for sub in Cc]
            r = subs[-1]
            for sub in reversed(subs[:-1]):
                r = r * ts[axis] + sub
            return r

        val = horner(C) * env
        for i, p in enumerate(parity):
            if p:
                val = val * np.sign(d(i))
        acc += val
    return scale * acc


def main():
    import jax
    import jax.numpy as jnp

    import linpde_gp_tpu as lgt
    from linpde_gp_tpu import backend
    from linpde_gp_tpu.ops import diffops
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel
    from linpde_gp_tpu.ops.gram import (
        kernel_term_specs,
        xla_gram_matvec,
        terms_gram,
    )

    backend.enable_compile_cache()
    on_gpu = backend.platform() == "gpu"
    n_acc = int(os.environ.get("NF_N", 4096 if on_gpu else 768))
    n_thr = int(os.environ.get("NF_THROUGHPUT_N", 32768 if on_gpu else 2048))

    prior_cov = 1.0 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
        lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    k_hh = apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, prior_cov, argnum=1), argnum=0
    )
    scale, terms = kernel_term_specs(k_hh)

    rng = np.random.default_rng(0)
    X = np.stack(
        [rng.uniform(0.0, 5.0, n_acc), rng.uniform(-1.0, 1.0, n_acc)], axis=-1
    ).astype(np.float32)

    _log(f"building f64 host oracle at n={n_acc} ...")
    K64 = _f64_gram_host(scale, terms, X)
    k0 = K64[0, 0]

    x_dev = jnp.asarray(X)
    results = {}
    for mode, comp in (("plain", False), ("compensated", True)):
        _log(f"assembling {mode} Gram on {jax.default_backend()} ...")
        t0 = time.perf_counter()
        K = scale * np.asarray(
            jax.jit(
                lambda a: terms_gram(terms, a, a, compensated=comp)
            )(x_dev),
            np.float64,
        )
        _log(f"  {mode} gram: {time.perf_counter() - t0:.1f} s (incl. compile)")
        E = K - K64
        # ||E||_2 by power iteration (E is symmetric up to roundoff).
        v = rng.standard_normal(n_acc)
        v /= np.linalg.norm(v)
        for _ in range(50):
            w = E @ v
            nw = np.linalg.norm(w)
            if nw == 0:
                break
            v = w / nw
        norm2 = float(np.linalg.norm(E @ v))
        results[mode] = dict(
            max_entry=float(np.max(np.abs(E)) / k0),
            norm2_rel=float(norm2 / k0),
            norm2_per_n=float(norm2 / k0 / n_acc),
        )
        _log(
            f"  {mode}: max|E|/k0 = {results[mode]['max_entry']:.3e}, "
            f"||E||2/k0 = {results[mode]['norm2_rel']:.3e} "
            f"(= {results[mode]['norm2_per_n']:.3e} * n)"
        )

    ratio = results["plain"]["norm2_rel"] / max(
        results["compensated"]["norm2_rel"], 1e-300
    )
    _log(f"coherent-error reduction (||E||2 plain / compensated): {ratio:.1f}x")

    # Throughput table.
    Xt = np.stack(
        [rng.uniform(0.0, 5.0, n_thr), rng.uniform(-1.0, 1.0, n_thr)], axis=-1
    ).astype(np.float32)
    v32 = rng.standard_normal(n_thr).astype(np.float32)
    xt_dev, v_dev = jnp.asarray(Xt), jnp.asarray(v32)
    table = {}
    for mode, comp in (("plain", False), ("compensated", True)):
        fn = jax.jit(
            lambda a, w: xla_gram_matvec(terms, a, a, w, compensated=comp)
        )
        t0 = time.perf_counter()
        out = fn(xt_dev, v_dev)
        _ = np.asarray(out[:4])
        _log(f"  {mode} matvec first call: {time.perf_counter() - t0:.1f} s")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(xt_dev, v_dev)
            _ = np.asarray(out[:4])
            times.append(time.perf_counter() - t0)
        best = min(times)
        pair_s = n_thr * n_thr / best
        table[mode] = dict(seconds=best, gpairs=pair_s / 1e9)
        _log(f"  {mode} matvec steady state at n={n_thr}: {best*1e3:.1f} ms "
             f"= {pair_s/1e9:.1f} G pair/s")

    slowdown = table["compensated"]["seconds"] / table["plain"]["seconds"]
    _log(f"compensated cost: {slowdown:.2f}x the plain matvec")

    import json

    print(json.dumps({
        "n_accuracy": n_acc,
        "plain": results["plain"],
        "compensated": results["compensated"],
        "coherent_reduction_x": ratio,
        "n_throughput": n_thr,
        "throughput": table,
        "compensated_slowdown_x": slowdown,
    }))


if __name__ == "__main__":
    main()
