"""Compensated sum-of-Kronecker Gram matvec for tensor-product grids.

On a ``TensorProductGrid`` the operator-transformed Gram is a sum of
Kronecker products of small 1-D factor matrices, so a matvec costs
O(N * sum_i n_i) instead of the O(N^2) streaming reduction — but the
PLAIN f32 evaluation of that structure is unusable at honest noise:
measured on the heat ``H k H*`` closed form at a (200, 100) grid,
``||E v|| / ||v|| ~ 7e-2`` — 140x the 1e-3-relative nugget — because the
nine closed-form terms cancel heavily (amplification ~600 eps32) and the
f32 GEMM accumulations over the factor dimensions add coherent rounding
on top.  (The streaming path hit the same wall and got ``ops/ff.py``;
this module is the grid analogue.)

Two compensation layers, mirroring the error sources:

1. FACTOR tables are evaluated on the host in float64 and split into
   exactly-representable float-float (hi, lo) f32 pairs — entry rounding
   of the factor Grams (the analogue of the streaming evaluator's
   coherent per-entry error) drops to ~eps32^2.
2. Every GEMM against a ``hi`` table is CHUNK-SPLIT along its contraction
   dimension with the partial products combined by error-free two_sum —
   the f32 GEMM accumulation error stays bounded by the chunk length
   (default 64) instead of the full factor dimension, and the
   cross terms ``A_lo @ v`` are added in ff.

Measured result (tests/test_kron_ff.py, CPU f32 vs the f64 oracle):
matvec error drops ~3 orders of magnitude below the plain f32 linop
path, putting the operator error well under a 1e-3-relative nugget.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .ff import two_sum


def eval_factor_np(spec, d):
    """Float64 numpy evaluation of a univariate term-spec factor
    (mirrors ``gram._eval_groups`` for one factor)."""
    kind, scale, poly, parity, prefactor = spec
    d = np.asarray(d, np.float64)
    if kind == "matern":
        t = float(scale) * np.abs(d)
        res = np.full_like(t, float(poly[-1]))
        for c in reversed(poly[:-1]):
            res = res * t + float(c)
        val = res * np.exp(-t)
        if parity:
            val = val * np.sign(d)
    elif kind == "expquad":
        z = float(scale) * d
        res = np.full_like(z, float(poly[-1]))
        for c in reversed(poly[:-1]):
            res = res * z + float(c)
        val = res * np.exp(-(z * z))
    else:
        raise NotImplementedError(f"factor kind {kind!r}")
    return float(prefactor) * val


def _ff_split(a64):
    hi = np.asarray(a64, np.float32)
    lo = np.asarray(a64 - hi.astype(np.float64), np.float32)
    return hi, lo


def _chunked_ff_matmul(A_hi, A_lo, V, chunk=64):
    """``A @ V`` with A an ff pair ((m, k) hi/lo) and V f32 (k, r):
    hi-product partials are chunked along k and combined by two_sum; the
    lo-product rides in the low word.  Returns an ff pair."""
    hi = jax.lax.Precision.HIGHEST
    k = A_hi.shape[1]
    s = None
    c = None
    for start in range(0, k, chunk):
        p = jnp.matmul(
            A_hi[:, start:start + chunk], V[start:start + chunk], precision=hi
        )
        if s is None:
            s, c = p, jnp.zeros_like(p)
        else:
            s, e = two_sum(s, p)
            c = c + e
    lo = jnp.matmul(A_lo, V, precision=hi)
    s, e = two_sum(s, lo)
    return s, c + e


def _ff_add(x, y):
    s, e = two_sum(x[0], y[0])
    return s, e + (x[1] + y[1])


class KronFFMatvec:
    """Compensated matvec for ``scale * sum_t c_t kron_i A_{t,i}`` on a
    2-factor tensor-product grid.

    Built from a ``kernel_term_specs`` spec and the HOST (f64) grid
    factors; the returned callable is jit-traceable, maps f32 ``(n,)`` or
    ``(n, r)`` to f32, and carries its ff factor tables as closure
    constants (small: the factor matrices are O(n_i^2)).
    """

    def __init__(self, spec, grid_factors, *, chunk=64):
        scale, terms = spec
        factors64 = [np.asarray(g, np.float64).reshape(-1) for g in grid_factors]
        if len(factors64) != 2:
            raise NotImplementedError("KronFFMatvec supports 2-D grids")
        self.shape_factors = tuple(len(g) for g in factors64)
        self.chunk = int(chunk)
        n = int(np.prod(self.shape_factors))
        self.n = n
        d_mats = [g[:, None] - g[None, :] for g in factors64]
        self._tables = []
        for coeff, fspecs in terms:
            per_dim = []
            for i, fs in enumerate(fspecs):
                a64 = float(scale if i == 0 else 1.0) * float(
                    coeff if i == 0 else 1.0
                ) * eval_factor_np(fs, d_mats[i])
                per_dim.append(tuple(jnp.asarray(x) for x in _ff_split(a64)))
            self._tables.append(per_dim)

    def __call__(self, v):
        v = jnp.asarray(v)
        vector = v.ndim == 1
        if vector:
            v = v[:, None]
        nt, nx = self.shape_factors
        r = v.shape[1]
        hi_prec = jax.lax.Precision.HIGHEST
        acc = None
        # v reshaped C-order: row index = t * nx + x  ->  (nt, nx * r)?
        # Keep r by moving it next to x: V (nt, nx, r).
        V = v.reshape(nt, nx, r)
        for (A_hi, A_lo), (B_hi, B_lo) in self._tables:
            # W = A @ V  over the t axis (contract nt).
            W_hi, W_lo = _chunked_ff_matmul(
                A_hi, A_lo, V.reshape(nt, nx * r), self.chunk
            )
            W_hi = W_hi.reshape(nt, nx, r)
            W_lo = W_lo.reshape(nt, nx, r)
            # Y = contract the x axis against B: (nt, r, nx) @ B^T.
            Wt_hi = jnp.swapaxes(W_hi, 1, 2).reshape(nt * r, nx)
            Wt_lo = jnp.swapaxes(W_lo, 1, 2).reshape(nt * r, nx)
            Y_hi, Y_cl = _chunked_ff_matmul(
                B_hi, B_lo, Wt_hi.T, self.chunk
            )
            # cross term: B_hi @ W_lo (the W low word) in plain f32.
            Y_cross = jnp.matmul(B_hi, Wt_lo.T, precision=hi_prec)
            term = (Y_hi, Y_cl + Y_cross)  # (nx, nt*r) ff
            term = (
                jnp.swapaxes(term[0].reshape(nx, nt, r), 0, 1),
                jnp.swapaxes(term[1].reshape(nx, nt, r), 0, 1),
            )
            acc = term if acc is None else _ff_add(acc, term)
        out = (acc[0] + acc[1]).reshape(self.n, r)
        return out[:, 0] if vector else out
