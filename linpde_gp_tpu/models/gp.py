"""Gaussian-process inference engine.

Parity: reference ``randprocs/_gaussian_process/_conditional.py`` —
``ConditionalGaussianProcess`` with incremental block-Cholesky
conditioning (call stack SURVEY.md §3.1/§3.2) — re-architected for an
accelerator:

- The Gram factor is ONE dense device-resident lower-triangular matrix,
  grown by ``chol_extend`` (triangular solve + matmul + small Cholesky)
  instead of the reference's nested ``BlockMatrix2x2`` tree.
- Posterior state ``(chol, residuals, weights)`` is a JAX pytree of
  arrays; all evaluation paths are jittable closures.
- Conditioning again NEVER refactorizes the old block (the reference's
  ``schur_update`` capability, ``linops/_block.py:226-268``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.crosscov.base import (
    ConcatenatedCrossCovariance,
    apply_functional_to_crosscov,
)
from ..ops.functionals.base import LinearFunctional
from ..ops.functionals.evaluation import _EvaluationFunctional
from ..ops.kernels.base import CovarianceFunction
from ..ops.linalg.chol import cho_solve, chol_extend, cholesky, solve_triangular
from ..ops.linalg.covariance import Covariance
from .functions.base import Function
from .randvars import Constant, Normal, asrandvar


class GaussianProcess:
    """Prior GP ``u ~ GP(mean, cov)``.

    Examples
    --------
    Condition on point observations and evaluate the posterior:

    >>> import numpy as np, jax.numpy as jnp
    >>> import linpde_gp_tpu as lgt
    >>> gp = lgt.GaussianProcess(
    ...     lgt.functions.Zero(()),
    ...     lgt.kernels.Matern((), nu=1.5, lengthscales=1.0))
    >>> post = gp.condition_on_observations(
    ...     np.asarray([0.0, 1.0]), X=np.asarray([0.0, 1.0]))
    >>> round(float(post.mean(jnp.asarray(0.5))), 4)
    0.5291

    Condition on OPERATOR observations (here ``-u'' = 2``, the 1-D
    Poisson equation) — conditioning shrinks the uncertainty:

    >>> from linpde_gp_tpu.ops import diffops
    >>> gp2 = lgt.GaussianProcess(
    ...     lgt.functions.Zero(()), lgt.kernels.Matern((), nu=2.5))
    >>> D = -1.0 * diffops.Laplacian(())
    >>> post2 = gp2.condition_on_observations(
    ...     np.full(3, 2.0), X=np.linspace(-1.0, 1.0, 3), L=D)
    >>> bool(float(post2.std(jnp.asarray(0.0)))
    ...      < float(gp2.std(jnp.asarray(0.0))))
    True
    """

    def __init__(self, mean: Function, cov: CovarianceFunction):
        if mean.input_shape != cov.input_shape:
            raise ValueError("mean/cov input shapes do not match")
        if mean.output_shape != cov.output_shape_0:
            raise ValueError("mean/cov output shapes do not match")
        self._mean = mean
        self._cov = cov

    @property
    def mean(self) -> Function:
        return self._mean

    @property
    def cov(self) -> CovarianceFunction:
        return self._cov

    @property
    def input_shape(self):
        return self._cov.input_shape

    @property
    def output_shape(self):
        return self._cov.output_shape_0

    # ------------------------------------------------------------------
    def __call__(self, X) -> Normal:
        """Marginal at points ``X`` (evaluation-functional layout)."""
        from ..ops.transforms.functionals import apply_functional

        L = _EvaluationFunctional(self.input_shape, self.output_shape, X)
        return apply_functional(L, self)

    def var(self, x) -> jnp.ndarray:
        k = self._cov(x)
        if self._cov.output_ndim_0 == 1 and self._cov.output_ndim_1 == 1:
            k = jnp.diagonal(k, axis1=-2, axis2=-1)
        return k

    def std(self, x) -> jnp.ndarray:
        # Clamp: posterior variances can round to tiny negatives.
        return jnp.sqrt(jnp.maximum(self.var(x), 0.0))

    def sample(self, key, X, sample_shape=()):
        return self(X).sample(key, sample_shape)

    @functools.cached_property
    def mean_jit(self):
        """Jit-compiled posterior-mean evaluator (the evaluation hot path)."""
        return jax.jit(self.mean)

    @functools.cached_property
    def std_jit(self):
        return jax.jit(self.std)

    @functools.cached_property
    def var_jit(self):
        return jax.jit(self.var)

    def condition_on_observations(self, Y, X=None, *, L=None, b=None):
        return ConditionalGaussianProcess.from_observations(
            self, Y, X=X, L=L, b=b
        )

    # -- preprocessing (reference ``_conditional.py:296-399``) -----------
    @staticmethod
    def _preprocess_observations(prior: "GaussianProcess", Y, X, L, b):
        from ..ops.diffops.linfuncop import LinearFunctionOperator
        from ..ops.transforms.functionals import apply_functional

        if isinstance(L, LinearFunctional):
            if X is not None:
                raise TypeError("If `L` is a LinearFunctional, `X` must be None.")
        elif isinstance(L, LinearFunctionOperator):
            if X is None:
                raise ValueError("`X` is required when `L` is an operator.")
            L = L.to_linfunctl(X)
        elif L is None:
            if X is None:
                raise ValueError("`X` and `L` cannot both be omitted.")
            L = _EvaluationFunctional(prior.input_shape, prior.output_shape, X)
        else:
            raise TypeError(f"Unsupported observation functional: {L!r}")

        if b is not None:
            b = asrandvar(b)
            if not isinstance(b, (Constant, Normal)):
                raise TypeError("`b` must be Normal or Constant")
            if tuple(b.shape) != tuple(L.output_shape):
                raise ValueError(
                    f"noise shape {b.shape} != functional output {L.output_shape}"
                )

        # Predictive moments via the rule engine.
        kLa = apply_functional(L, prior.cov, argnum=1)
        gram_block = apply_functional_to_crosscov(L, kLa)
        pred_mean = L.apply_to_function(prior.mean).reshape(-1)

        # Observation vector with the evaluation-functional layout fix
        # (reference ``_conditional.py:366-388``).
        Y = jnp.asarray(Y)
        out_ndim = len(prior.output_shape)
        if isinstance(L, _EvaluationFunctional) and out_ndim > 0:
            if Y.shape[-out_ndim:] != prior.output_shape:
                raise ValueError(
                    f"Expected Y with trailing shape {prior.output_shape}, "
                    f"got {Y.shape}"
                )
            Y = jnp.moveaxis(
                Y,
                tuple(range(Y.ndim - out_ndim, Y.ndim)),
                tuple(range(out_ndim)),
            )
        if tuple(Y.shape) != tuple(L.output_shape):
            raise ValueError(
                f"Expected Y of shape {L.output_shape}, got {Y.shape}."
            )
        Y = Y.reshape(-1)

        gram = gram_block.matrix
        if b is not None:
            pred_mean = pred_mean + b.mean.reshape(-1)
            gram = gram + b.cov.matrix

        return Y, L, b, kLa, pred_mean, gram


class _CholSolve:
    """Picklable plain Cholesky solver (posterior-state checkpointing)."""

    def __init__(self, chol):
        self.chol = chol

    def __call__(self, B):
        return cho_solve(self.chol, B)


class _RefinedSolve:
    """Picklable mixed-precision refined solver (``ops/linalg/refine``)."""

    def __init__(self, gram, chol):
        self.gram = gram
        self.chol = chol

    def __call__(self, B):
        from ..ops.linalg.refine import refined_solve

        return refined_solve(self.gram, self.chol, B)


def _make_gram_solver(gram: jnp.ndarray):
    """Factor a Gram and return ``(chol, gram_kept, solve)``.

    Default: full-precision Cholesky, ``solve = cho_solve``.  With
    ``config.solve_refinement`` and a float64 Gram: float32 factor +
    float64 preconditioned-CG refinement (``ops/linalg/refine.py``) —
    float32 factorization speed at the reference's 1e-6 parity.  The
    Gram is kept only in refinement mode (it feeds the residual matvecs
    and incremental extension).
    """
    from ..config import config as _config

    if _config.solve_refinement and gram.dtype == jnp.float64:
        chol = cholesky(
            gram.astype(jnp.float32), jitter=_config.refine_factor_jitter
        )
        return chol, gram, _RefinedSolve(gram, chol)

    chol = cholesky(gram)
    return chol, None, _CholSolve(chol)


class ConditionalGaussianProcess(GaussianProcess):
    """Posterior GP after conditioning on linear-functional observations."""

    def __init__(
        self,
        *,
        prior: GaussianProcess,
        Ys,
        Ls,
        bs,
        kLas: ConcatenatedCrossCovariance,
        chol: jnp.ndarray,
        residuals: jnp.ndarray,
        representer_weights: jnp.ndarray,
        gram: jnp.ndarray | None = None,
        solve=None,
    ):
        self._prior = prior
        self._Ys = tuple(Ys)
        self._Ls = tuple(Ls)
        self._bs = tuple(bs)
        self._kLas = kLas
        self._chol = chol
        self._gram = gram
        self._residuals = residuals
        self._representer_weights = representer_weights
        # ``solve`` is the refined mixed-precision solver (None in plain
        # dense mode, where the triangular fast paths apply).
        refined = solve
        if solve is None:
            solve = functools.partial(cho_solve, chol)
        self._solve = solve
        super().__init__(
            mean=ConditionalMean(prior.mean, kLas, representer_weights),
            cov=ConditionalCovariance(prior.cov, kLas, chol, solve=refined),
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_observations(cls, prior, Y, X=None, *, L=None, b=None):
        Y, L, b, kLa, pred_mean, gram = GaussianProcess._preprocess_observations(
            prior, Y, X, L, b
        )
        chol, gram_kept, solve = _make_gram_solver(gram)
        resid = Y - pred_mean
        weights = solve(resid)
        return cls(
            prior=prior,
            Ys=(Y,),
            Ls=(L,),
            bs=(b,),
            kLas=ConcatenatedCrossCovariance((kLa,)),
            chol=chol,
            residuals=resid,
            representer_weights=weights,
            gram=gram_kept,
            solve=solve,
        )

    @property
    def prior(self) -> GaussianProcess:
        return self._prior

    @property
    def gram_cholesky(self) -> jnp.ndarray:
        return self._chol

    @property
    def representer_weights(self) -> jnp.ndarray:
        return self._representer_weights

    @property
    def kLas(self) -> ConcatenatedCrossCovariance:
        return self._kLas

    @property
    def log_marginal_likelihood(self) -> jnp.ndarray:
        """``log p(Y | prior)`` of all conditioned observations — the
        model-evidence surface for hyperparameter selection."""
        from ..ops.linalg.chol import logdet_from_chol

        n = self._residuals.shape[0]
        quad = jnp.dot(
            self._residuals, self._representer_weights,
            precision=jax.lax.Precision.HIGHEST,
        )
        return -0.5 * (
            quad + logdet_from_chol(self._chol) + n * jnp.log(2.0 * jnp.pi)
        )

    def condition_on_observations(self, Y, X=None, *, L=None, b=None):
        """Incremental conditioning — extends the cached Cholesky factor,
        never refactorizing the old Gram (reference ``_conditional.py:
        253-294``)."""
        Y, L, b, kLa, pred_mean, gram = GaussianProcess._preprocess_observations(
            self._prior, Y, X, L, b
        )
        # Cross-covariance of the new functional with all previous ones.
        cross = apply_functional_to_crosscov(L, self._kLas).matrix  # (m, n)
        chol = chol_extend(
            self._chol, cross.T.astype(self._chol.dtype), gram.astype(self._chol.dtype)
        )
        resid = jnp.concatenate([self._residuals, Y - pred_mean])
        gram_kept = None
        solve = None
        if self._gram is not None:
            # Refinement mode: grow the high-precision Gram alongside the
            # low-precision factor.
            gram_kept = jnp.block([[self._gram, cross.T], [cross, gram]])
            solve = _RefinedSolve(gram_kept, chol)
            weights = solve(resid)
        else:
            weights = cho_solve(chol, resid)
        return ConditionalGaussianProcess(
            prior=self._prior,
            Ys=self._Ys + (Y,),
            Ls=self._Ls + (L,),
            bs=self._bs + (b,),
            kLas=self._kLas.append(kLa),
            chol=chol,
            residuals=resid,
            representer_weights=weights,
            gram=gram_kept,
            solve=solve,
        )

    # ------------------------------------------------------------------
    def _apply_operator(self, op) -> "ConditionalGaussianProcess":
        """Operator pushforward ``T(u | obs)`` reusing Gram factor and
        weights (reference ``_conditional.py:432-450``)."""
        from ..ops.transforms.dispatch import apply_operator

        new_prior = GaussianProcess(
            mean=apply_operator(op, self._prior.mean),
            cov=apply_operator(op, self._prior.cov),
        )
        return ConditionalGaussianProcess(
            prior=new_prior,
            Ys=self._Ys,
            Ls=self._Ls,
            bs=self._bs,
            kLas=self._kLas.apply_operator(op),
            chol=self._chol,
            residuals=self._residuals,
            representer_weights=self._representer_weights,
            gram=self._gram,
            solve=self._solve,
        )

    def solve_gram(self, B: jnp.ndarray) -> jnp.ndarray:
        """Solve ``Gram @ X = B`` through the posterior's solver (refined
        in mixed-precision mode, plain Cholesky otherwise)."""
        return self._solve(B)

    def var(self, x) -> jnp.ndarray:
        """Pointwise posterior variance (vmap/shard-friendly)."""
        x = jnp.asarray(x)
        u = self._kLas.evaluate(x)  # batch + out + (n,)
        prior_var = self._prior.var(x)
        n = u.shape[-1]
        ut = u.reshape(-1, n).T
        if self._gram is None:
            q = solve_triangular(self._chol, ut)
            update = jnp.sum(q**2, axis=0).reshape(u.shape[:-1])
        else:
            update = jnp.sum(ut * self._solve(ut), axis=0).reshape(u.shape[:-1])
        return jnp.maximum(prior_var - update, 0.0)


class ConditionalMean(Function):
    """``m(x) + kLas(x) @ weights`` (reference ``_conditional.py:177-204``)."""

    def __init__(self, prior_mean, kLas, weights):
        self._prior_mean = prior_mean
        self._kLas = kLas
        self._weights = weights
        super().__init__(prior_mean.input_shape, prior_mean.output_shape)

    def _evaluate(self, x):
        m = self._prior_mean._evaluate(x)
        batch = x.shape[: x.ndim - self.input_ndim]
        m = jnp.broadcast_to(m, batch + self.output_shape)
        return m + self._kLas.matvec(x, self._weights)


class ConditionalCovariance(CovarianceFunction):
    """``k(x0,x1) - kLas(x0) K^{-1} kLas(x1)^T``
    (reference ``_conditional.py:206-251``)."""

    def __init__(self, prior_cov: CovarianceFunction, kLas, chol, *, solve=None):
        self._prior_cov = prior_cov
        self._kLas = kLas
        self._chol = chol
        # Optional mixed-precision refined solver (``ops/linalg/refine``);
        # None selects the plain Cholesky paths.
        self._refined = solve
        super().__init__(
            prior_cov.input_shape,
            prior_cov.output_shape_0,
            prior_cov.output_shape_1,
        )

    def _solve_gram(self, B):
        if self._refined is not None:
            return self._refined(B)
        return cho_solve(self._chol, B)

    def _evaluate(self, x0, x1):
        k = self._prior_cov._evaluate(x0, x1)
        u0 = self._kLas.evaluate(x0)  # batch0 + out0 + (n,)
        u1 = self._kLas.evaluate(x1)  # batch1 + out1 + (n,)
        n = u0.shape[-1]
        v1 = self._solve_gram(u1.reshape(-1, n).T).T.reshape(u1.shape)
        d0 = self.output_ndim_0
        d1 = self.output_ndim_1
        if d0 == 0 and d1 == 0:
            update = jnp.sum(u0 * v1, axis=-1)
        else:
            # Outer product over codomain axes.
            u0e = u0.reshape(u0.shape[:-1] + (1,) * d1 + (n,))
            v1e = v1.reshape(
                v1.shape[: v1.ndim - 1 - d1] + (1,) * d0 + v1.shape[-1 - d1 : -1] + (n,)
            )
            update = jnp.sum(u0e * v1e, axis=-1)
        return k - update

    def matrix(self, X0, X1=None):
        K = self._prior_cov.matrix(X0, X1)
        disc0 = _EvaluationFunctional(
            self.input_shape, self.output_shape_0, X0
        )
        u0 = apply_functional_to_crosscov(disc0, self._kLas).matrix
        if X1 is None:
            u1 = u0
        else:
            disc1 = _EvaluationFunctional(
                self.input_shape, self.output_shape_1, X1
            )
            u1 = apply_functional_to_crosscov(disc1, self._kLas).matrix
        if self._refined is not None:
            return K - u0 @ self._refined(u1.T)
        q0 = solve_triangular(self._chol, u0.T)
        q1 = q0 if X1 is None else solve_triangular(self._chol, u1.T)
        return K - q0.T @ q1
