"""Covariance-function layer.

Capability parity with the reference's JAX kernel stack
(``covfuncs/_jax.py``, ``covfuncs/_jax_arithmetic.py``) with ONE design
delta (SURVEY.md §7): a single jnp evaluation path per kernel instead of
the reference's numpy/jax/KeOps triple.  The same ``_evaluate`` runs

- eagerly and under ``jit`` (posterior evaluation closures),
- under ``jax.jvp``/``jax.jacfwd`` (the autodiff fallback used when no
  closed-form operator-transformed kernel is registered), and
- inside the fused Gram reductions of ``ops/gram.py`` (the KeOps
  replacement).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ...utils.shapes import ShapeType, as_shape, size


class CovarianceFunction:
    """Covariance function ``k(x0, x1)`` between (possibly multi-output)
    random processes.

    ``input_shape`` is the domain shape; ``output_shape_0`` /
    ``output_shape_1`` are the codomain shapes of the two process slots.
    """

    def __init__(self, input_shape, output_shape_0=(), output_shape_1=()) -> None:
        self._input_shape: ShapeType = as_shape(input_shape)
        self._output_shape_0: ShapeType = as_shape(output_shape_0)
        self._output_shape_1: ShapeType = as_shape(output_shape_1)

    @property
    def input_shape(self) -> ShapeType:
        return self._input_shape

    @property
    def input_ndim(self) -> int:
        return len(self._input_shape)

    @property
    def input_size(self) -> int:
        return size(self._input_shape)

    @property
    def output_shape_0(self) -> ShapeType:
        return self._output_shape_0

    @property
    def output_shape_1(self) -> ShapeType:
        return self._output_shape_1

    @property
    def output_ndim_0(self) -> int:
        return len(self._output_shape_0)

    @property
    def output_ndim_1(self) -> int:
        return len(self._output_shape_1)

    @property
    def output_size_0(self) -> int:
        return size(self._output_shape_0)

    @property
    def output_size_1(self) -> int:
        return size(self._output_shape_1)

    # ------------------------------------------------------------------
    def __call__(self, x0, x1=None):
        """Broadcasting evaluation.

        ``x0``: ``batch0 + input_shape``; ``x1``: ``batch1 + input_shape``
        (or ``None`` for the diagonal ``k(x0, x0)``).  Returns
        ``broadcast(batch0, batch1) + output_shape_0 + output_shape_1``.
        """
        x0 = jnp.asarray(x0)
        x1 = x0 if x1 is None else jnp.asarray(x1)
        return self._evaluate(x0, x1)

    def jax(self, x0, x1=None):
        """Alias kept for reference-API familiarity."""
        return self.__call__(x0, x1)

    def _evaluate(self, x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def pairwise(self, X0, X1):
        """Pairwise evaluation: ``(n0,)+input`` × ``(n1,)+input`` →
        ``(n0, n1) + output_shape_0 + output_shape_1``."""
        X0 = jnp.asarray(X0)
        X1 = jnp.asarray(X1)
        x0 = X0.reshape((-1,) + self._input_shape)
        x1 = X1.reshape((-1,) + self._input_shape)
        expand0 = (slice(None),) + (None,) * 1
        return self._evaluate(
            x0[(slice(None), None) + (slice(None),) * self.input_ndim],
            x1[(None, slice(None)) + (slice(None),) * self.input_ndim],
        )

    def matrix(self, X0, X1=None) -> jnp.ndarray:
        """Dense Gram matrix with the reference's flattening contract:
        output (codomain) dimensions come BEFORE batch dimensions on both
        axes (see ``linfunctls/_evaluation.py:10-27`` and
        ``randvars/_covariance.py:118-135``)."""
        X0 = jnp.asarray(X0)
        X1 = X0 if X1 is None else jnp.asarray(X1)
        n0 = size(X0.shape[: X0.ndim - self.input_ndim])
        n1 = size(X1.shape[: X1.ndim - self.input_ndim])
        gram = self.pairwise(X0, X1)  # (n0, n1) + out0 + out1
        d0, d1 = self.output_ndim_0, self.output_ndim_1
        # (n0, n1) + out0 + out1 -> out0 + (n0,) + out1 + (n1,)
        perm = (
            tuple(range(2, 2 + d0))
            + (0,)
            + tuple(range(2 + d0, 2 + d0 + d1))
            + (1,)
        )
        gram = jnp.transpose(gram, perm)
        return gram.reshape(self.output_size_0 * n0, self.output_size_1 * n1)

    def linop(self, X0, X1=None):
        """Structured-operator Gram; subclasses override when structure
        (Kronecker, block) is available."""
        from ..linalg.linops import Dense

        return Dense(self.matrix(X0, X1))

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        from .arithmetic import SumCovarianceFunction

        if isinstance(other, CovarianceFunction):
            return SumCovarianceFunction(self, other)
        return NotImplemented

    def __mul__(self, scalar):
        if np.ndim(scalar) == 0:
            from .arithmetic import ScaledCovarianceFunction

            return ScaledCovarianceFunction(self, scalar)
        return NotImplemented

    __rmul__ = __mul__


class StationaryMixin:
    """Utilities for kernels of the form ``k(x0, x1) = φ(scaled diffs)``.

    ``lengthscales`` broadcasts over the input shape, matching probnum's
    per-dimension lengthscale semantics consumed by the reference.
    """

    def _init_stationary(self, lengthscales) -> None:
        self.lengthscales = np.broadcast_to(
            np.asarray(lengthscales, dtype=np.float64),
            self.input_shape,
        )

    def _diffs(self, x0, x1, scale_factors):
        return (x0 - x1) * scale_factors

    def _squared_scaled_distances(self, x0, x1, scale_factors) -> jnp.ndarray:
        diffs = self._diffs(x0, x1, scale_factors)
        if self.input_ndim == 0:
            return diffs**2
        return jnp.sum(diffs**2, axis=tuple(range(-self.input_ndim, 0)))

    def _scaled_distances(self, x0, x1, scale_factors) -> jnp.ndarray:
        if self.input_ndim == 0:
            return jnp.abs(self._diffs(x0, x1, scale_factors))
        # sqrt is non-differentiable at 0; closed-form kernels avoid this
        # path on the diagonal, the autodiff fallback uses `_safe_sqrt`.
        return jnp.sqrt(self._squared_scaled_distances(x0, x1, scale_factors))
