"""Preconditioner spectroscopy for the north-star conditioning problem.

Question: the N=1e5 honest-noise solve took 326 PCG iterations with a
float32 rank-4096 Nystrom preconditioner — which preconditioner cuts the
iteration count to <=~80?  This script answers it on the HOST: it
assembles the exact benchmark Gram (heat ``H k H*`` on the TensorProduct
Matern(1.5)xMatern(2.5) prior, uniform space-time points) in float64 at
a reduced n, measures its spectrum, and counts flexible-PCG iterations
under candidate preconditioners:

- Nystrom rank sweep (the current scheme, including ranks above 4096,
  which the streamed build makes feasible);
- IDEAL two-level: M = (K + s2p I)^{-1} by Cholesky — the limit of a
  plain-f32 inner solve (s2p = the enlarged nugget the f32 coherent
  error floor forces);
- practical two-level: k_inner inner CG iterations on (K + s2p I),
  Nystrom-preconditioned, inside an outer flexible PCG;
- block-Jacobi additive Schwarz on space-filling-curve blocks, alone
  and with a Nystrom coarse-space deflation.

Everything is numpy float64 — iteration counts here are spectrum-driven
(a compensated or float64 matvec's noise sits far below the 1e-3
nugget), so they transfer to the device up to the modeled
inner-operator error.  Outputs one JSON line per config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def eval_factor(kind, s, poly, parity, pref, d):
    if kind == "matern":
        t = s * np.abs(d)
        res = np.full_like(t, poly[-1])
        for c in reversed(poly[:-1]):
            res = res * t + c
        val = res * np.exp(-t)
        if parity:
            val = val * np.sign(d)
    else:
        z = s * d
        res = np.full_like(z, poly[-1])
        for c in reversed(poly[:-1]):
            res = res * z + c
        val = res * np.exp(-(z * z))
    return pref * val


def build_gram(terms, scale, X0, X1, chunk=2048):
    """Row-chunked dense f64 Gram of a sum-of-products term spec."""
    n0, n1 = X0.shape[0], X1.shape[0]
    K = np.empty((n0, n1))
    for r0 in range(0, n0, chunk):
        r1 = min(r0 + chunk, n0)
        acc = None
        cache = {}
        for coeff, factors in terms:
            term = None
            for i, spec in enumerate(factors):
                key = (i, spec)
                if key not in cache:
                    d = X0[r0:r1, None, i] - X1[None, :, i]
                    cache[key] = eval_factor(*spec, d)
                val = cache[key]
                term = val if term is None else term * val
            term = coeff * term
            acc = term if acc is None else acc + term
        K[r0:r1] = scale * acc
    return K


def kernel_diag(terms, scale):
    def _f0(f):
        kind, s, poly, parity, pref = f
        return 0.0 if parity else pref * poly[0]

    return scale * sum(
        float(c) * float(np.prod([_f0(f) for f in fs])) for c, fs in terms
    )


def fpcg(matvec, b, M=None, tol=1e-5, maxiter=2000):
    """Flexible (Polak-Ribiere) PCG, iteration-count oriented."""
    if M is None:
        M = lambda r: r
    x = np.zeros_like(b)
    r = b.copy()
    z = M(r)
    p = z
    rz = float(r @ z)
    b_norm = float(np.linalg.norm(b))
    thr = tol * b_norm
    k = 0
    while float(np.linalg.norm(r)) > thr and k < maxiter:
        Ap = matvec(p)
        alpha = rz / float(p @ Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new = float(r_new @ z)
        beta = max((rz_new - float(z @ r)) / rz, 0.0)
        p = z + beta * p
        r, rz = r_new, rz_new
        k += 1
    return x, k, float(np.linalg.norm(r)) / b_norm


def nystrom_np(K, m, sigma_sq, K_XZ=None, K_ZZ=None):
    n = K.shape[0]
    if K_XZ is None:
        idx = ((np.arange(m) + 0.5) * (n / m)).astype(np.int64)
        K_XZ = K[:, idx]
        K_ZZ = K_XZ[idx]
    K_XZ = np.asarray(K_XZ, np.float64)
    K_ZZ = np.asarray(K_ZZ, np.float64)
    stab = np.finfo(np.float64).eps * np.trace(K_ZZ) * m
    L = np.linalg.cholesky(K_ZZ + stab * np.eye(m))
    import scipy.linalg

    B = scipy.linalg.solve_triangular(L, K_XZ.T, lower=True).T
    C0 = B.T @ B
    C0 = 0.5 * (C0 + C0.T)
    lam = np.linalg.eigvalsh(C0)
    lam_m = max(lam[0], 100.0 * np.finfo(np.float64).eps * lam[-1])
    delta = lam_m + sigma_sq
    chol_C = np.linalg.cholesky(C0 + delta * np.eye(m))

    def apply(r):
        w = scipy.linalg.cho_solve((chol_C, True), B.T @ r)
        return (r - B @ w) / delta

    return apply, lam_m


def block_jacobi_np(K, X, sigma_sq, nb):
    """Additive-Schwarz block-Jacobi on Morton-ordered point blocks."""
    import scipy.linalg

    n = K.shape[0]
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    u = ((X - lo) / (hi - lo) * 0xFFFF).astype(np.uint64)

    def interleave(a, b):
        out = np.zeros_like(a)
        for i in range(16):
            out |= ((a >> i) & 1) << (2 * i + 1)
            out |= ((b >> i) & 1) << (2 * i)
        return out

    order = np.argsort(interleave(u[:, 0], u[:, 1]), kind="stable")
    factors = []
    for s in range(0, n, nb):
        ids = order[s:s + nb]
        Kb = K[np.ix_(ids, ids)] + sigma_sq * np.eye(len(ids))
        factors.append((ids, np.linalg.cholesky(Kb)))

    def apply(r):
        out = np.zeros_like(r)
        for ids, L in factors:
            out[ids] = scipy.linalg.cho_solve((L, True), r[ids])
        return out

    return apply


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--noise", type=float, default=1e-3)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=2000)
    ap.add_argument("--spectrum", action="store_true",
                    help="also compute/save the full eigenvalue spectrum")
    ap.add_argument("--configs", type=str, default="all")
    ap.add_argument("--ranks", type=str, default="1024,2048,4096")
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from bench import _build_kernels
    from linpde_gp_tpu.ops.gram import kernel_term_specs

    k_hh, _ = _build_kernels()
    scale, terms = kernel_term_specs(k_hh)

    n = args.n
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], -1)
    Y = rng.standard_normal(n)

    t0 = time.time()
    K = build_gram(terms, scale, X, X)
    K = 0.5 * (K + K.T)
    diag = kernel_diag(terms, scale)
    sigma_sq = args.noise * diag
    log(f"gram built n={n} in {time.time() - t0:.1f}s, diag={diag:.4g}, "
        f"sigma_sq={sigma_sq:.4g}")

    results = []

    def record(name, iters, relres, extra=None):
        row = {"config": name, "n": n, "noise": args.noise,
               "iters": iters, "relres": relres}
        if extra:
            row.update(extra)
        results.append(row)
        print(json.dumps(row), flush=True)

    if args.spectrum:
        t0 = time.time()
        lam = np.linalg.eigvalsh(K)
        np.save(f"/tmp/spectrum_n{n}.npy", lam)
        above = int(np.sum(lam > sigma_sq))
        log(f"spectrum in {time.time() - t0:.1f}s: lam_max={lam[-1]:.4g} "
            f"lam_min={lam[0]:.4g}; #eigs > sigma_sq: {above} "
            f"(= {above / n:.3f} n); lam[{n//2}]={lam[n//2]:.4g}")
        for frac in (0.5, 0.25, 0.125, 0.0625, 0.03125):
            m = int(n * frac)
            log(f"  lam at rank {m} (from top): {lam[-m]:.5g} "
                f"-> kappa_precond ~ {lam[-m] / sigma_sq:.1f}")

    matvec = lambda v: K @ v + sigma_sq * v  # noqa: E731
    want = args.configs.split(",") if args.configs != "all" else [
        "none", "nystrom", "ideal2l", "two_level", "bj", "bj_deflated"]

    if "none" in want:
        _, it, rr = fpcg(matvec, Y, None, args.tol, args.maxiter)
        record("plain_cg", it, rr)

    ranks = tuple(int(r) for r in args.ranks.split(","))

    if "nystrom" in want:
        for m in ranks:
            if m > n // 2:
                continue
            t0 = time.time()
            M, lam_m = nystrom_np(K, m, sigma_sq)
            _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
            record(f"nystrom_m{m}", it, rr,
                   {"lam_m": lam_m, "lam_m_over_sigma": lam_m / sigma_sq,
                    "build_s": round(time.time() - t0, 1)})

    if "nystrom_f32" in want:
        # Hypothesis test: excess PCG iterations at N=1e5 (326 vs ~100
        # spectrum-predicted) come from the PLAIN-f32 build of the
        # preconditioner factors, whose coherent evaluation error
        # (~3.3e-7*n*k0, ops/ff.py) dwarfs sigma^2 at scale.  Reproduce
        # on host: evaluate K_XZ/K_ZZ in float32.
        for m in ranks:
            if m > n // 2:
                continue
            idx = ((np.arange(m) + 0.5) * (n / m)).astype(np.int64)
            X32 = X.astype(np.float32)
            K_XZ32 = build_gram(
                tuple(
                    (np.float32(c), tuple(
                        (k_, np.float32(s_), tuple(np.float32(p) for p in poly_),
                         par_, np.float32(pf_))
                        for (k_, s_, poly_, par_, pf_) in fs))
                    for c, fs in terms
                ),
                np.float32(scale), X32, X32[idx])
            M, lam_m = nystrom_np(K, m, sigma_sq, K_XZ=K_XZ32,
                                  K_ZZ=K_XZ32[idx])
            _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
            record(f"nystrom_f32build_m{m}", it, rr, {"lam_m": lam_m})

    if "nystrom_grid" in want:
        # Landmarks on a regular grid over the domain instead of a
        # strided subset of the (random uniform) collocation points.
        for m in (1024, 2048, 4096):
            if m > n // 2:
                continue
            mt = int(np.sqrt(m / 2.0) * np.sqrt(5.0 / 2.0))
            mx = max(1, m // max(mt, 1))
            tg = np.linspace(0.0, 5.0, mt + 2)[1:-1]
            xg = np.linspace(-1.0, 1.0, mx + 2)[1:-1]
            Z = np.stack(np.meshgrid(tg, xg, indexing="ij"), -1).reshape(-1, 2)
            K_XZ = build_gram(terms, scale, X, Z)
            K_ZZ = build_gram(terms, scale, Z, Z)
            M, lam_m = nystrom_np(K, Z.shape[0], sigma_sq, K_XZ=K_XZ,
                                  K_ZZ=0.5 * (K_ZZ + K_ZZ.T))
            _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
            record(f"nystrom_grid_m{Z.shape[0]}", it, rr, {"lam_m": lam_m})

    if "ideal2l" in want:
        import scipy.linalg

        for s2p_rel in (0.3, 0.1, 0.03):
            s2p = s2p_rel * diag
            L = np.linalg.cholesky(K + s2p * np.eye(n))
            M = lambda r: scipy.linalg.cho_solve((L, True), r)  # noqa: E731
            _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
            record(f"ideal2l_s{s2p_rel:g}", it, rr)

    if "two_level" in want:
        for s2p_rel, k_inner in ((0.03, 5), (0.03, 10), (0.1, 10)):
            s2p = s2p_rel * diag
            Mi, _ = nystrom_np(K, min(2048, n // 4), s2p)
            inner_mv = lambda v: K @ v + s2p * v  # noqa: E731

            def M(r, inner_mv=inner_mv, Mi=Mi, k_inner=k_inner):
                z, _, _ = fpcg(inner_mv, r, Mi, tol=1e-12, maxiter=k_inner)
                return z

            _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
            record(f"two_level_s{s2p_rel:g}_k{k_inner}", it, rr)

    if "bj" in want:
        for nb in (512, 1024):
            M = block_jacobi_np(K, X, sigma_sq, nb)
            _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
            record(f"block_jacobi_nb{nb}", it, rr)

    if "bj_deflated" in want:
        import scipy.linalg

        M_as = block_jacobi_np(K, X, sigma_sq, 1024)
        for m in (1024, 2048):
            if m > n // 2:
                continue
            idx = ((np.arange(m) + 0.5) * (n / m)).astype(np.int64)
            K_XZ = K[:, idx]
            Q, _ = np.linalg.qr(K_XZ)
            A_c = Q.T @ (K @ Q) + sigma_sq * (Q.T @ Q)
            Lc = np.linalg.cholesky(0.5 * (A_c + A_c.T))

            def M(r, Q=Q, Lc=Lc):
                coarse = Q @ scipy.linalg.cho_solve((Lc, True), Q.T @ r)
                return M_as(r) + coarse

            _, it, rr = fpcg(matvec, Y, M, args.tol, args.maxiter)
            record(f"bj1024_deflated_m{m}", it, rr)

    log("done: " + json.dumps(results))


if __name__ == "__main__":
    main()
