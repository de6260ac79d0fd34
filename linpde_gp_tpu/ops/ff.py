"""Float-float ("double-single") arithmetic for compensated kernel
evaluation in float32.

Motivation: the float32 streaming Gram evaluation carries a COHERENT
per-entry relative error of ~1e-6 (rounding bias of the transcendentals
and Horner chains), so the computed Gram ``K + E`` has ``lambda_min``
drifting like ``-1e-6 * N * k(0)``.  At ``N = 1e5`` that forces ~10%
observation noise to keep float32 CG convergent.  The reference never
faces this because it is float64 end-to-end on CPU (e.g. its
machine-precision posterior parity test,
``tests/linpde_gp/randprocs/test_posterior_gp.py:152-162``).

The fix: carry the difference, the scaled distance, the Horner chains
and the exponential in unevaluated float32 PAIRS ``(hi, lo)`` with
``hi + lo`` accurate to ~``eps32**2``.  All building blocks are
error-free transformations (Knuth two-sum, Dekker two-prod on halves
split by a bit mask, which stay exact whether or not the compiler fuses
multiplies into adds) plus a Cody-Waite style accurate ``exp``.
Every op is an elementwise jnp op, so the module works identically
under ``shard_map`` and in plain XLA.

Cost: ~20-25x the arithmetic of the plain evaluation, for a per-entry
error of ~1e-13 relative instead of ~1e-6.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "two_sum",
    "two_diff",
    "two_prod",
    "ff_add",
    "ff_add_const",
    "ff_mul",
    "ff_sqr",
    "ff_neg",
    "ff_abs",
    "ff_scale",
    "ff_exp",
    "ff_const",
]


_SPLIT_MASK = {
    # Keep the sign, the exponent and the top 11 (float32) / 25 (float64)
    # explicit mantissa bits: 0xFFFFF000 and 0xFFFFFFFFF8000000 as signed.
    "float32": (jnp.int32, -(1 << 12)),
    "float64": (jnp.int64, -(1 << 27)),
}


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e, requiring |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def two_diff(a, b):
    """Error-free a - b = s + e."""
    s = a - b
    bb = s - a
    e = (a - (s - bb)) - (b + bb)
    return s, e


def _split(a, dtype):
    """``a = hi + lo`` with ``hi`` the leading mantissa bits of ``a``, cut
    by a bit mask.  Veltkamp's arithmetic split (``c = 4097 a; hi = c -
    (c - a)``) is wrong once a compiler contracts ``c - a`` into a fused
    multiply-add, as GPU compilers do; the mask split has no arithmetic to
    contract.  ``a`` is coerced to the computation dtype first."""
    itype, mask = _SPLIT_MASK[jnp.dtype(dtype).name]
    if isinstance(a, (float, int, np.number)):  # constant: split on the host
        x = np.array([a], jnp.dtype(dtype))
        hi = (x.view(np.dtype(itype)) & mask).view(x.dtype)
        return hi[0], (x - hi)[0]
    a = jnp.asarray(a, dtype)
    bits = jax.lax.bitcast_convert_type(a, itype) & mask
    hi = jax.lax.bitcast_convert_type(bits, dtype)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker's product on masked halves).

    Every partial product of the halves is exact in float32 (and all but
    ``al * bl``, ~eps**3 of ``p``, in float64), so the result does not
    change whether or not the compiler fuses a multiply into an add."""
    p = a * b
    dtype = jnp.result_type(p)
    ah, al = _split(a, dtype)
    bh, bl = _split(b, dtype)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- float-float pairs (hi, lo) ---------------------------------------------


# The pair is kept UNNORMALIZED (|lo| may grow to a few ulps of hi over
# a chain) — hi+lo stays accurate to ~eps^2 * chain_length, far below
# the ~1e-10 target, and skipping the renormalization saves ~25% of the
# arithmetic in the hot Gram evaluator.


def ff_add(x, y):
    s, e = two_sum(x[0], y[0])
    return s, e + (x[1] + y[1])


def ff_add_const(x, c_hi, c_lo):
    s, e = two_sum(x[0], c_hi)
    return s, e + (x[1] + c_lo)


def ff_mul(x, y):
    p, e = two_prod(x[0], y[0])
    return p, e + (x[0] * y[1] + x[1] * y[0])


def ff_sqr(x):
    p, e = two_prod(x[0], x[0])
    return p, e + 2.0 * (x[0] * x[1])


def ff_neg(x):
    return (-x[0], -x[1])


def ff_abs(x):
    s = jnp.where(x[0] < 0, -1.0, 1.0).astype(x[0].dtype)
    return (x[0] * s, x[1] * s)


def ff_const(c: float, dtype):
    """Split a Python float into an (hi, lo) pair for ``dtype``."""
    if jnp.dtype(dtype) == jnp.float32:
        hi = float(np.float32(c))
        lo = float(np.float32(c - hi))
    else:
        hi, lo = float(c), 0.0
    return hi, lo


def ff_scale(x, scale: float):
    """Multiply an ff pair by an exact Python float (split per dtype)."""
    dtype = jnp.result_type(x[0])
    s_hi, s_lo = ff_const(scale, dtype)
    p, e = two_prod(x[0], s_hi)
    return p, e + (x[0] * s_lo + x[1] * s_hi)


# -- exp ---------------------------------------------------------------------

import math as _math

_LN2 = 0.6931471805599453094172321
_LOG2E = 1.4426950408889634073599247
# Taylor 1/k!, k = 0..10: rel. truncation error <= 0.347**11/11! ~ 2e-13
# on the reduced range |r| <= ln2/2 — an order of magnitude below the
# 1e-10 coherent-noise target, two Horner steps
# cheaper than full eps^2.
_EXP_COEFFS = [1.0 / float(_math.factorial(k)) for k in range(11)]


def _exp2_int(kf, dtype):
    """Exact 2**k for integer-valued float ``kf`` via exponent bits."""
    if jnp.dtype(dtype) == jnp.float32:
        bits = (kf.astype(jnp.int32) + 127) << 23
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    bits = (kf.astype(jnp.int64) + 1023) << 52
    return jax.lax.bitcast_convert_type(bits, jnp.float64)


def ff_exp(x):
    """``exp(x)`` of an ff pair, accurate to ~eps32**2 relatively.

    Range reduction ``x = k*ln2 + r`` with the ``k*ln2`` product carried
    error-free (two_prod against the split ln2), degree-12 Taylor Horner
    on ``|r| <= ln2/2`` in ff, exact ``2**k`` scaling via exponent bits.
    Arguments are clamped at the underflow edge (results there are
    ~1e-38, i.e. exactly-zero kernel tails).
    """
    dtype = jnp.result_type(x[0])
    f32 = jnp.dtype(dtype) == jnp.float32
    lo_clamp = -87.0 if f32 else -708.0
    hi_clamp = 87.0 if f32 else 708.0
    clamped = (x[0] < lo_clamp) | (x[0] > hi_clamp)
    xh = jnp.clip(x[0], lo_clamp, hi_clamp)
    xl = jnp.where(clamped, 0.0, x[1]).astype(dtype)

    kf = jnp.floor(xh * _LOG2E + 0.5)
    ln2_hi, ln2_lo = ff_const(_LN2, dtype)
    ph, pe = two_prod(kf, ln2_hi)
    pe = pe + kf * ln2_lo
    # r = x - k*ln2 (ff; the leading two_sum cancels exactly).
    rh, re = two_sum(xh, -ph)
    r = (rh, re + (xl - pe))

    c_hi, c_lo = ff_const(_EXP_COEFFS[-1], dtype)
    acc = (jnp.full_like(rh, c_hi), jnp.full_like(rh, c_lo))
    for c in reversed(_EXP_COEFFS[:-1]):
        c_hi, c_lo = ff_const(c, dtype)
        acc = ff_add_const(ff_mul(acc, r), c_hi, c_lo)

    two_k = _exp2_int(kf, dtype)
    return (acc[0] * two_k, acc[1] * two_k)
