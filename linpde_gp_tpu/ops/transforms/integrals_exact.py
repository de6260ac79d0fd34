r"""Exact Lebesgue integrals of (transformed) half-integer Matérn kernels.

Parity: reference ``crosscov/linfunctls/integrals/_matern_lebesgue.py``
(exact ``∫k`` antiderivatives and ``∫∫k``) and
``covfuncs/linfunctls/_registry.py:176-196``.

Derivation (independent, same rational-polynomial machinery):  with
``φ(s) = q(s) e^{-s}`` and ``Φ(s) = ∫_0^s φ = R(0) - R(s) e^{-s}`` where
``R = Σ_j q^{(j)}`` (the exponential-integration-by-parts series),

    ∫_a^b φ(c|x - t|) dt = (1/c) [ g(c(x-a)) - g(c(x-b)) ],
    g(s) = sign(s) Φ(|s|)                       (odd primitive)

    ∫_a^b ∫_a^b φ(c|s - t|) dt ds = (2/c²) [ R(0)·T - S(0) + S(T) e^{-T} ],
    S = Σ_j R^{(j)},   T = c(b - a).

Both exact in rational arithmetic; evaluation is one Horner chain per
endpoint instead of a quadrature contraction.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ...models.functions.polynomial import RationalPolynomial
from ..kernels.stationary import Matern, half_integer_matern_coefficients


@functools.lru_cache(maxsize=None)
def _exp_primitive_poly(coeffs_key) -> tuple:
    """``R = Σ_j p^{(j)}`` such that ``d/ds [-R(s) e^{-s}] = p(s) e^{-s}``."""
    p = RationalPolynomial([Fraction(c) for c in coeffs_key])
    total = p
    d = p
    for _ in range(p.degree):
        d = d.differentiate()
        total = total + d
    return tuple(total.rational_coefficients)


def _matern_R(p_order: int) -> RationalPolynomial:
    q = half_integer_matern_coefficients(p_order)
    return RationalPolynomial(_exp_primitive_poly(tuple(q)))


def matern_integral_crosscov(nu: float, lengthscale: float, a: float, b: float):
    """Return a jittable ``x ↦ ∫_a^b k(x, t) dt`` for a 1-D Matérn."""
    p_order = int(nu - 0.5)
    c = float(np.sqrt(2 * nu) / lengthscale)
    R = _matern_R(p_order)
    R0 = float(R.coefficients[0])
    r_coeffs = tuple(R.coefficients)

    def g(s):
        t = jnp.abs(s)
        horner = jnp.full_like(t, r_coeffs[-1])
        for ck in reversed(r_coeffs[:-1]):
            horner = horner * t + ck
        return jnp.sign(s) * (R0 - horner * jnp.exp(-t))

    def evaluate(x):
        return (g(c * (x - a)) - g(c * (x - b))) / c

    return evaluate


def matern_double_integral(nu: float, lengthscale: float, a: float, b: float) -> float:
    """Exact ``∫_a^b ∫_a^b k(s, t) dt ds`` for a 1-D Matérn."""
    p_order = int(nu - 0.5)
    c = float(np.sqrt(2 * nu) / lengthscale)
    R = _matern_R(p_order)
    S = RationalPolynomial(_exp_primitive_poly(tuple(R.rational_coefficients)))
    T = c * (b - a)
    R0 = float(R.coefficients[0])
    S0 = float(S.coefficients[0])
    s_coeffs = S.coefficients
    horner = s_coeffs[-1]
    for ck in reversed(s_coeffs[:-1]):
        horner = horner * T + ck
    return (2.0 / c**2) * (R0 * T - S0 + horner * float(np.exp(-T)))


def _matern_Rt(p_order: int) -> RationalPolynomial:
    """``Rt = Σ_j (s·q)^{(j)}`` so ``Ψ(s) = ∫_0^s t q(t) e^{-t} dt
    = Rt(0) − Rt(s) e^{-s}`` (first-moment primitive)."""
    q = half_integer_matern_coefficients(p_order)
    tq = (Fraction(0),) + tuple(Fraction(c) for c in q)  # s·q(s)
    return RationalPolynomial(_exp_primitive_poly(tq))


def _hat_segment_tables(basis):
    """Per-hat linear-piece tables ``(a, b, alpha, beta)``, each ``(m, 2)``,
    with invalid boundary pieces zeroed out (``w(t) = alpha t + beta`` on
    ``[a, b]``; matches ``basis.eval_elem`` semantics)."""
    x_im1, x_i, x_ip1 = basis.x_im1, basis.x_i, basis.x_ip1
    ls = 1.0 / (x_i - x_im1)
    rs = 1.0 / (x_ip1 - x_i)
    a = np.stack([x_im1, x_i], axis=1)
    b = np.stack([x_i, x_ip1], axis=1)
    alpha = np.stack([ls, -rs], axis=1)
    beta = np.stack([-x_im1 * ls, x_ip1 * rs], axis=1)
    valid = np.ones_like(a, dtype=bool)
    if not basis.zero_boundary:
        valid[0, 0] = False  # boundary hats: flat extension clamped to 0
        valid[-1, 1] = False
    alpha = np.where(valid, alpha, 0.0)
    beta = np.where(valid, beta, 0.0)
    return a, b, alpha, beta


def matern_hat_projection_crosscov(nu: float, lengthscale: float, basis):
    r"""Exact ``x ↦ [∫ φ_i(t) k(x, t) dt]_i`` for half-integer Matérn.

    Reference parity + generalization: the reference carries this closed
    form only for ν = 3/2 (``crosscov/linfunctls/projections.py:131``);
    the rational-recurrence machinery here covers every half-integer
    order.  Derivation: each hat is two linear pieces ``w(t) = α t + β``
    on ``[a, b]``; with ``u = t − x``,

        ∫_a^b (α t + β) φ(c|t − x|) dt
            = (α x + β) A(x) + α B(x),
        A(x) = (1/c)  [g(c(x−a)) − g(c(x−b))],   g(s) = sign(s) Φ(|s|),
        B(x) = −(1/c²)[G(c(x−a)) − G(c(x−b))],   G(s) = Ψ(|s|),

    where ``Φ/Ψ`` are the zeroth/first-moment primitives of
    ``q(s)e^{-s}`` (exponential integration-by-parts series, exact in
    rational arithmetic).  Evaluation is four Horner chains per segment
    endpoint — jittable, O(n·m) elementwise work.
    """
    p_order = int(nu - 0.5)
    c = float(np.sqrt(2 * nu) / lengthscale)
    R = _matern_R(p_order)
    Rt = _matern_Rt(p_order)
    r_coeffs = tuple(R.coefficients)
    rt_coeffs = tuple(Rt.coefficients)
    R0 = float(r_coeffs[0])
    Rt0 = float(rt_coeffs[0])

    a, b, alpha, beta = _hat_segment_tables(basis)

    a_j = jnp.asarray(a)
    b_j = jnp.asarray(b)
    alpha_j = jnp.asarray(alpha)
    beta_j = jnp.asarray(beta)

    def _horner(coeffs, t):
        h = jnp.full_like(t, coeffs[-1])
        for ck in reversed(coeffs[:-1]):
            h = h * t + ck
        return h

    def g(s):  # odd primitive of φ(|·|)
        t = jnp.abs(s)
        return jnp.sign(s) * (R0 - _horner(r_coeffs, t) * jnp.exp(-t))

    def G(s):  # even first-moment primitive
        t = jnp.abs(s)
        return Rt0 - _horner(rt_coeffs, t) * jnp.exp(-t)

    def evaluate(x):
        # x: (...,) scalar domain; returns (..., m).
        xe = x[..., None, None]  # vs (m, 2) segment tables
        sa = c * (xe - a_j)
        sb = c * (xe - b_j)
        A = (g(sa) - g(sb)) / c
        B = -(G(sa) - G(sb)) / c**2
        seg = (alpha_j * xe + beta_j) * A + alpha_j * B
        return jnp.sum(seg, axis=-1)

    return evaluate


def _shift_poly(coeffs, j: int):
    """Coefficients of ``u^j * p(u)`` from coefficients of ``p``."""
    return (Fraction(0),) * j + tuple(Fraction(c) for c in coeffs)


@functools.lru_cache(maxsize=None)
def _moment_primitive_tables(p_order: int, max_j: int, first_moment: bool):
    """Antiderivative data for ``∫ u^j h(u) du``, ``j = 0..max_j``, where
    ``h = g`` (odd zeroth-moment primitive of ``φ``) when
    ``first_moment=False`` and ``h = G`` (even first-moment primitive)
    when ``True``.

    On ``u >= 0``: ``h(u) = H0 − H(u) e^{-u}``, so
    ``F_j(u) = H0 u^{j+1}/(j+1) + E_j(u) e^{-u}`` with
    ``E_j = Σ_k (u^j H)^{(k)}`` (exponential integration-by-parts).
    Returns ``(H0, [(E_j coeffs, F_j(0), odd_extension_j)])``; the global
    antiderivative is the odd/even extension dictated by the integrand's
    parity (``u^j g`` is odd for even ``j``; ``u^j G`` is odd for odd
    ``j`` — an odd integrand gets an EVEN antiderivative and vice versa).
    """
    base = _matern_Rt(p_order) if first_moment else _matern_R(p_order)
    base_c = tuple(base.rational_coefficients)
    h0 = base_c[0]
    rows = []
    for j in range(max_j + 1):
        e_j = _exp_primitive_poly(_shift_poly(base_c, j))
        f0 = float(e_j[0])  # F_j(0) = E_j(0) (the H0-term vanishes at 0)
        integrand_odd = (j % 2 == 0) if not first_moment else (j % 2 == 1)
        rows.append((tuple(float(c) for c in e_j), f0, not integrand_odd))
    return float(h0), rows


def _eval_moment_primitive(u, h0, e_coeffs, f0, odd, j):
    """Global antiderivative of ``u^j h(u)`` (see above) at ``u``."""
    t = np.abs(u)
    horner = np.full_like(t, e_coeffs[-1])
    for ck in reversed(e_coeffs[:-1]):
        horner = horner * t + ck
    f_plus = h0 * t ** (j + 1) / (j + 1) + horner * np.exp(-t)
    if odd:
        return np.sign(u) * (f_plus - f0)
    return f_plus


def matern_hat_double_projection_gram(
    nu: float, lengthscale: float, basis_out, basis_in
) -> np.ndarray:
    r"""Exact ``G_ij = ∫∫ w_i(s) w_j(t) k(s, t) dt ds`` for hat bases and
    a half-integer Matérn ``k`` — the double-projection Gram block, in
    closed form for EVERY half-integer ν (the reference reaches machine
    precision here only through quadrature; its exact projection formulas
    stop at the crosscov level, ``crosscov/linfunctls/projections.py``).

    Derivation: the inner integral is the projection crosscov
    ``inner(s) = (α₂s+β₂)A(s) + α₂B(s)`` (see
    :func:`matern_hat_projection_crosscov`); the outer integral of
    ``(α₁s+β₁)·inner(s)`` reduces to moments
    ``∫ s^m g(c(s−e)) ds`` (m ≤ 2) and ``∫ s^m G(c(s−e)) ds`` (m ≤ 1),
    each an explicit antiderivative via the exponential
    integration-by-parts series in exact rational arithmetic.  Host
    numpy float64 — Gram assembly for FEM observation blocks is a
    one-time O(m²) setup cost.
    """
    p_order = int(nu - 0.5)
    c = float(np.sqrt(2 * nu) / lengthscale)

    g0, g_rows = _moment_primitive_tables(p_order, 2, False)
    G0, G_rows = _moment_primitive_tables(p_order, 1, True)

    a1, b1, al1, be1 = _hat_segment_tables(basis_out)
    a2, b2, al2, be2 = _hat_segment_tables(basis_in)

    # Broadcast segment pairs: out (m1, 2) -> (m1, 2, 1, 1); in -> (1, 1, m2, 2).
    a1 = a1[:, :, None, None]
    b1 = b1[:, :, None, None]
    al1 = al1[:, :, None, None]
    be1 = be1[:, :, None, None]
    a2 = a2[None, None, :, :]
    b2 = b2[None, None, :, :]
    al2 = al2[None, None, :, :]
    be2 = be2[None, None, :, :]

    from math import comb

    def moment_integral(e, m, h0, rows):
        """``∫_{a1}^{b1} s^m h(c(s−e)) ds`` elementwise over the pair grid."""
        u_hi = c * (b1 - e)
        u_lo = c * (a1 - e)
        total = 0.0
        for j in range(m + 1):
            e_coeffs, f0, odd = rows[j]
            d = _eval_moment_primitive(
                u_hi, h0, e_coeffs, f0, odd, j
            ) - _eval_moment_primitive(u_lo, h0, e_coeffs, f0, odd, j)
            total = total + comb(m, j) * e ** (m - j) * c ** (-j) * d
        return total / c

    # P2(s) = (α₁s+β₁)(α₂s+β₂) = p2 s² + p1 s + p0; P1(s) = α₂(α₁s+β₁).
    p2 = al1 * al2
    p1 = al1 * be2 + al2 * be1
    p0 = be1 * be2
    q1 = al2 * al1
    q0 = al2 * be1

    def contract_g(e):
        return (
            p0 * moment_integral(e, 0, g0, g_rows)
            + p1 * moment_integral(e, 1, g0, g_rows)
            + p2 * moment_integral(e, 2, g0, g_rows)
        )

    def contract_G(e):
        return q0 * moment_integral(e, 0, G0, G_rows) + q1 * moment_integral(
            e, 1, G0, G_rows
        )

    seg = (contract_g(a2) - contract_g(b2)) / c - (
        contract_G(a2) - contract_G(b2)
    ) / c**2
    return seg.sum(axis=(1, 3))


def exact_projection_gram(functional_out, crosscov):
    """If ``crosscov`` is ``k L_in*`` with a (scaled) 1-D half-integer
    Matérn ``k`` and both ``functional_out`` and ``L_in`` are hat-basis
    load vectors / L2 projections, return the exact dense Gram block
    ``(functional_out.output_size, crosscov.randvar_size)``; else None."""
    from ..crosscov.base import KernelFunctionalCrossCov
    from ..functionals.projections import (
        BasisIntegralFunctional,
        L2Projection_UnivariateLinearInterpolationBasis,
    )
    from ..kernels.arithmetic import ScaledCovarianceFunction
    from ..kernels.stationary import Matern

    if not isinstance(crosscov, KernelFunctionalCrossCov):
        return None

    def unwrap(functional):
        if isinstance(functional, L2Projection_UnivariateLinearInterpolationBasis):
            return functional.basis, (
                functional.normalizer if functional.normalized else None
            )
        if isinstance(functional, BasisIntegralFunctional):
            return functional.basis, None
        return None

    out = unwrap(functional_out)
    inner = unwrap(crosscov.functional)
    if out is None or inner is None:
        return None
    basis_out, norm_out = out
    basis_in, norm_in = inner

    scale = 1.0
    k = crosscov.kernel
    while isinstance(k, ScaledCovarianceFunction):
        scale *= k.scalar
        k = k.covfunc
    if not isinstance(k, Matern) or k.input_size > 1 or k.nu == np.inf:
        return None
    if not k.is_half_integer:
        return None
    l = (
        float(np.ravel(k.lengthscales)[0])
        if np.ndim(k.lengthscales)
        else float(k.lengthscales)
    )
    raw = scale * matern_hat_double_projection_gram(k.nu, l, basis_out, basis_in)
    if norm_out is not None:
        raw = np.asarray(norm_out) @ raw
    if norm_in is not None:
        raw = raw @ np.asarray(norm_in).T
    return jnp.asarray(raw)


def exact_projection_crosscov(kernel, functional):
    """If ``kernel`` is a (scaled) 1-D half-integer Matérn and
    ``functional`` a hat-basis load vector / L2 projection, return the
    exact jittable crosscov ``x ↦ (..., n_basis)``; else ``None``."""
    from ..functionals.projections import (
        BasisIntegralFunctional,
        L2Projection_UnivariateLinearInterpolationBasis,
    )
    from ..kernels.arithmetic import ScaledCovarianceFunction

    normalizer = None
    if isinstance(functional, L2Projection_UnivariateLinearInterpolationBasis):
        basis = functional.basis
        if functional.normalized:
            normalizer = functional.normalizer
    elif isinstance(functional, BasisIntegralFunctional):
        basis = functional.basis
    else:
        return None

    scale = 1.0
    k = kernel
    while isinstance(k, ScaledCovarianceFunction):
        scale *= k.scalar
        k = k.covfunc
    if not isinstance(k, Matern) or k.input_size > 1 or k.nu == np.inf:
        return None
    if not k.is_half_integer:
        return None
    l = (
        float(np.ravel(k.lengthscales)[0])
        if np.ndim(k.lengthscales)
        else float(k.lengthscales)
    )
    fn = matern_hat_projection_crosscov(k.nu, l, basis)
    norm_j = None if normalizer is None else jnp.asarray(normalizer)

    squeeze_input = k.input_shape == (1,)

    def crosscov_fn(x):
        if squeeze_input:
            x = x[..., 0]
        vals = scale * fn(x)
        if norm_j is not None:
            vals = vals @ norm_j.T
        return vals

    return crosscov_fn


def exact_integral_hooks(kernel, functional):
    """If ``kernel`` is a (scaled) 1-D half-integer Matérn and
    ``functional`` a Lebesgue integral over an Interval, return
    ``(crosscov_fn, gram_value)``; otherwise ``None``."""
    from ...models.domains import Interval
    from ..functionals.integrals import LebesgueIntegral
    from ..kernels.arithmetic import ScaledCovarianceFunction

    if not isinstance(functional, LebesgueIntegral):
        return None
    if not isinstance(functional.domain, Interval):
        return None
    scale = 1.0
    k = kernel
    while isinstance(k, ScaledCovarianceFunction):
        scale *= k.scalar
        k = k.covfunc
    if not isinstance(k, Matern) or k.input_size > 1 or k.nu == np.inf:
        return None
    if not k.is_half_integer:
        return None
    a, b = float(functional.domain[0]), float(functional.domain[1])
    l = float(np.ravel(k.lengthscales)[0]) if np.ndim(k.lengthscales) else float(k.lengthscales)
    fn = matern_integral_crosscov(k.nu, l, a, b)
    gram = scale * matern_double_integral(k.nu, l, a, b)

    def crosscov_fn(x):
        return scale * fn(x)

    return crosscov_fn, gram
