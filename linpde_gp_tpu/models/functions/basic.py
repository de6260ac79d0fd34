"""Concrete deterministic functions.

Parity targets (reference): ``Constant``/``Zero`` (``functions/_constant.py``),
``Affine`` (``_affine.py:8``), ``Piecewise``/``PiecewiseLinear``/
``PiecewiseConstant`` (``_piecewise.py:16,89,145``), ``TruncatedSineSeries``
(``_fourier.py:11``), ``TruncatedGaussianMixturePDF`` (``_truncated_gmm.py:11``),
``StackedFunction``/``stack`` (``_stack.py:10,47``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import jax.numpy as jnp
import numpy as np

from .base import Function, Zero
from .polynomial import Polynomial


class Constant(Function):
    def __init__(self, input_shape, value, output_shape=None):
        value = jnp.asarray(value)
        if output_shape is None:
            output_shape = value.shape
        super().__init__(input_shape, output_shape)
        self._value = jnp.broadcast_to(value, self.output_shape)

    @property
    def value(self):
        return self._value

    def _evaluate(self, x):
        batch_shape = x.shape[: x.ndim - self.input_ndim]
        return jnp.broadcast_to(
            self._value, batch_shape + self.output_shape
        ).astype(x.dtype)

    def __add__(self, other):
        if isinstance(other, Constant) and other.input_shape == self.input_shape:
            return Constant(self.input_shape, self._value + other.value)
        return super().__add__(other)

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            return Constant(self.input_shape, self._value * scalar)
        return super().__mul__(scalar)

    __rmul__ = __mul__


class Affine(Function):
    """``f(x) = A @ x + b`` (scalar case: ``a * x + b``).

    Reference: ``functions/_affine.py:8``.
    """

    def __init__(self, A, b):
        self._A = jnp.asarray(A)
        self._b = jnp.asarray(b)
        if self._A.ndim == 0:
            input_shape = ()
            output_shape = self._b.shape
        elif self._A.ndim == 1:
            input_shape = (self._A.shape[0],)
            output_shape = ()
        else:
            input_shape = (self._A.shape[1],)
            output_shape = (self._A.shape[0],)
        super().__init__(input_shape, output_shape)

    @property
    def A(self):
        return self._A

    @property
    def b(self):
        return self._b

    def _evaluate(self, x):
        if self._A.ndim == 0:
            return self._A * x + self._b
        return jnp.tensordot(x, self._A.T if self._A.ndim == 2 else self._A, axes=1) + self._b


class Piecewise(Function):
    """Scalar piecewise function on a partition ``xs``."""

    def __init__(self, xs, fns: Iterable[Function]):
        xs = np.atleast_1d(np.asarray(xs))
        if xs.ndim != 1:
            raise ValueError("`xs` must be one-dimensional")
        self._xs = xs
        fns = tuple(fns)
        if len(fns) != xs.size - 1:
            raise ValueError("need len(xs) - 1 pieces")
        if not all(f.input_shape == () and f.output_shape == () for f in fns):
            raise ValueError("pieces must be scalar functions")
        self._fns = fns
        super().__init__((), ())

    @property
    def xs(self) -> np.ndarray:
        return self._xs

    @property
    def pieces(self):
        return self._fns

    @property
    def num_pieces(self) -> int:
        return len(self._fns)

    def _evaluate(self, x):
        # Evaluate every piece and select — branchless, jit-friendly.
        out = jnp.zeros_like(x)
        for i, fn in enumerate(self._fns):
            lo, hi = self._xs[i], self._xs[i + 1]
            if i == 0:
                mask = (lo <= x) & (x <= hi)
            else:
                mask = (lo < x) & (x <= hi)
            out = jnp.where(mask, fn._evaluate(x), out)
        return out

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            return type(self)._scaled(self, scalar)
        return super().__mul__(scalar)

    __rmul__ = __mul__

    def __add__(self, other):
        # Piecewise + polynomial/constant stays piecewise (needed for
        # exact piecewise-polynomial PDE right-hand sides, reference
        # ``functions/_piecewise.py:102-131``).
        from .polynomial import Polynomial

        if isinstance(other, Constant):
            other = Polynomial((float(np.asarray(other.value)),))
        if np.ndim(other) == 0 and not isinstance(other, Function):
            other = Polynomial((float(other),))
        if isinstance(other, Polynomial):
            return Piecewise(self.xs, [p + other for p in self.pieces])
        return super().__add__(other)

    __radd__ = __add__

    @staticmethod
    def _scaled(piecewise, scalar):
        return Piecewise(piecewise.xs, [scalar * p for p in piecewise.pieces])


class PiecewiseLinear(Piecewise):
    @staticmethod
    def from_points(xs, ys) -> "PiecewiseLinear":
        xs = np.asarray(xs)
        ys = np.asarray(ys)
        pieces = []
        for l, r, y_l, y_r in zip(xs[:-1], xs[1:], ys[:-1], ys[1:]):
            slope = (y_r - y_l) / (r - l)
            pieces.append(Polynomial((y_l - slope * l, slope)))
        return PiecewiseLinear(xs=xs, fns=pieces)

    @staticmethod
    def _scaled(piecewise, scalar):
        return PiecewiseLinear(piecewise.xs, [scalar * p for p in piecewise.pieces])


class PiecewiseConstant(Piecewise):
    def __init__(self, xs, ys):
        ys = np.atleast_1d(np.asarray(ys))
        self._ys = ys
        super().__init__(xs, [Constant((), y) for y in ys])

    @property
    def ys(self) -> np.ndarray:
        return self._ys


class TruncatedSineSeries(Function):
    """``f(x) = sum_k c_k sin(k pi (x - l) / (r - l))`` on an interval;
    the heat-equation initial condition family (reference:
    ``functions/_fourier.py:11``)."""

    def __init__(self, domain, coefficients):
        from ..domains import asdomain

        self._domain = asdomain(domain)
        super().__init__(self._domain.shape, ())
        coefficients = np.asarray(coefficients, dtype=np.float64)
        if coefficients.ndim != 1:
            raise ValueError("coefficients must be one-dimensional")
        self._coefficients = coefficients

    @property
    def domain(self):
        return self._domain

    @property
    def coefficients(self) -> np.ndarray:
        return self._coefficients

    @property
    def half_angular_frequencies(self) -> np.ndarray:
        l, r = self._domain
        return np.pi * np.arange(1, self._coefficients.shape[-1] + 1) / (r - l)

    def _evaluate(self, x):
        l, _ = self._domain
        return jnp.sum(
            self._coefficients
            * jnp.sin(self.half_angular_frequencies * (x[..., None] - float(l))),
            axis=-1,
        )


class TruncatedGaussianMixturePDF(Function):
    """PDF of a Gaussian mixture truncated to an interval (reference:
    ``functions/_truncated_gmm.py:11``)."""

    def __init__(self, domain, means, stds, weights=None):
        from ..domains import asdomain
        from scipy import stats

        self._domain = asdomain(domain)
        super().__init__((), ())
        self._means = np.atleast_1d(np.asarray(means, dtype=np.float64))
        self._stds = np.broadcast_to(
            np.asarray(stds, dtype=np.float64), self._means.shape
        )
        n = self._means.shape[0]
        if weights is None:
            weights = np.full((n,), 1.0 / n)
        self._weights = np.asarray(weights, dtype=np.float64)
        a, b = self._domain
        # Normalization over the truncation interval.
        mass = stats.norm.cdf(
            (float(b) - self._means) / self._stds
        ) - stats.norm.cdf((float(a) - self._means) / self._stds)
        self._norms = self._weights / (mass * self._stds * np.sqrt(2 * np.pi))

    def _evaluate(self, x):
        z = (x[..., None] - self._means) / self._stds
        vals = jnp.sum(self._norms * jnp.exp(-0.5 * z**2), axis=-1)
        a, b = self._domain
        inside = (x >= float(a)) & (x <= float(b))
        return jnp.where(inside, vals, 0.0)


class StackedFunction(Function):
    """Stack single-output functions into a multi-output function
    (reference: ``functions/_stack.py:10``)."""

    def __init__(self, *fns: Function):
        fns = tuple(fns)
        input_shape = fns[0].input_shape
        if not all(f.input_shape == input_shape for f in fns):
            raise ValueError("All stacked functions must share an input shape.")
        if not all(f.output_shape == () for f in fns):
            raise ValueError("Can only stack scalar-output functions.")
        self._fns = fns
        super().__init__(input_shape, (len(fns),))

    @property
    def fns(self):
        return self._fns

    def _evaluate(self, x):
        return jnp.stack([f._evaluate(x) for f in self._fns], axis=-1)


def stack(fns: Sequence[Function]) -> StackedFunction:
    return StackedFunction(*fns)
