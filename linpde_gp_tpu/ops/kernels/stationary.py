"""ExpQuad and (half-integer) Matérn covariance functions.

Parity: reference ``covfuncs/_expquad.py:11`` and ``covfuncs/_matern.py:12``
(probnum conventions: ``ExpQuad`` is ``exp(-0.5 ||(x0-x1)/l||^2)``;
``Matern`` uses scaled distance ``t = sqrt(2 nu) ||(x0-x1)/l||`` with a
half-integer polynomial-times-exponential closed form).  The exact
rational polynomial coefficients are the substrate for the closed-form
derivative kernels in ``ops.diffops`` / ``ops.transforms``.
"""

from __future__ import annotations

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ...models.functions.polynomial import RationalPolynomial
from .base import CovarianceFunction, StationaryMixin


class ExpQuad(StationaryMixin, CovarianceFunction):
    r"""``k(x0, x1) = exp(-1/2 \sum_i ((x0_i - x1_i)/l_i)^2)``."""

    def __init__(self, input_shape=(), lengthscales=1.0):
        super().__init__(input_shape)
        self._init_stationary(lengthscales)
        self._scale_factors = 1.0 / (np.sqrt(2.0) * self.lengthscales)

    @property
    def scale_factors(self) -> np.ndarray:
        return self._scale_factors

    def _evaluate(self, x0, x1):
        return jnp.exp(
            -self._squared_scaled_distances(x0, x1, self._scale_factors)
        )

    def __repr__(self):
        return f"ExpQuad(input_shape={self.input_shape}, l={self.lengthscales})"


def half_integer_matern_coefficients(p: int) -> tuple[Fraction, ...]:
    r"""Exact coefficients ``c_i`` of the Matérn polynomial
    ``k(t) = exp(-t) \sum_{i=0}^p c_i t^i`` for ``nu = p + 1/2`` with
    ``t = sqrt(2 nu) ||x0 - x1|| / l``.

    Derived from the standard closed form (Rasmussen & Williams eq. 4.16):
    ``c_{p-i} = p!/(2p)! * (p+i)!/(i!(p-i)!) * 2^{p-i}``.  Mirrors the
    capability of probnum's ``Matern.half_integer_coefficients`` consumed
    by the reference at ``covfuncs/_matern.py:30``.
    """
    p = int(p)
    coeffs = [Fraction(0)] * (p + 1)
    lead = Fraction(math.factorial(p), math.factorial(2 * p))
    for i in range(p + 1):
        deg = p - i
        coeffs[deg] = (
            lead
            * Fraction(math.factorial(p + i), math.factorial(i) * math.factorial(p - i))
            * Fraction(2) ** deg
        )
    return tuple(coeffs)


class Matern(StationaryMixin, CovarianceFunction):
    r"""Matérn covariance with smoothness ``nu``.

    ``nu = inf`` degenerates to the Gaussian kernel; half-integer ``nu``
    uses the exact polynomial closed form evaluated by a Horner chain
    (the hot path).  General ``nu`` evaluates via the modified
    Bessel function ``K_nu`` (``ops.kernels.bessel``) — capability
    parity with probnum's numpy layer, which the reference's jax path
    lacks (``covfuncs/_matern.py:46`` raises).

    Examples
    --------
    >>> import jax.numpy as jnp
    >>> from linpde_gp_tpu.ops.kernels import Matern
    >>> k = Matern((), nu=1.5, lengthscales=1.0)
    >>> float(k(jnp.asarray(0.0), jnp.asarray(0.0)))
    1.0
    >>> round(float(k(jnp.asarray(0.0), jnp.asarray(1.0))), 6)
    0.483358
    >>> k.matrix(jnp.linspace(0.0, 1.0, 3)).shape
    (3, 3)
    """

    def __init__(self, input_shape=(), nu: float = 1.5, lengthscales=1.0):
        super().__init__(input_shape)
        if nu <= 0:
            raise ValueError("nu must be positive")
        self._nu = float(nu)
        self._init_stationary(lengthscales)
        if self._nu == np.inf:
            self._scale_factors = 1.0 / (np.sqrt(2.0) * self.lengthscales)
            self._poly = None
        else:
            self._scale_factors = np.sqrt(2 * self._nu) / self.lengthscales
            self._poly = (
                RationalPolynomial(half_integer_matern_coefficients(self.p))
                if self.is_half_integer
                else None
            )

    @property
    def nu(self) -> float:
        return self._nu

    @property
    def is_half_integer(self) -> bool:
        return self._nu != np.inf and float(2 * self._nu) == int(2 * self._nu) and int(
            2 * self._nu
        ) % 2 == 1

    @property
    def p(self) -> int:
        assert self.is_half_integer
        return int(self._nu - 0.5)

    @property
    def polynomial(self) -> RationalPolynomial:
        """The exact Matérn polynomial in the scaled distance ``t``."""
        return self._poly

    @property
    def scale_factors(self) -> np.ndarray:
        return self._scale_factors

    def _evaluate(self, x0, x1):
        if self._nu == np.inf:
            return jnp.exp(
                -self._squared_scaled_distances(x0, x1, self._scale_factors)
            )
        t = self._scaled_distances(x0, x1, self._scale_factors)
        if self._poly is None:
            from .bessel import matern_bessel

            return matern_bessel(self._nu, t)
        return self._poly._evaluate(t) * jnp.exp(-t)

    def __repr__(self):
        return (
            f"Matern(input_shape={self.input_shape}, nu={self._nu}, "
            f"l={self.lengthscales})"
        )
