"""Process–vector cross-covariances: the ``k L*`` objects.

Parity: reference ``crosscov/_pv_crosscov.py:14`` and the concrete
``CovarianceFunction_{Identity,Dirac,Evaluation}_...`` classes plus
integral/projection crosscovs (``crosscov/linfunctls/``).

Design delta: ONE generic ``KernelFunctionalCrossCov`` covers all
functional families through the functional's discretization (points +
weights), with the transformed kernel carried symbolically.  The
meticulous axis-layout transposes of the reference
(``crosscov/linfunctls/_evaluation.py:21,176``) are centralized in
``_contract_functional_axis``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ...utils.shapes import ShapeType, as_shape, size
from ..functionals.base import (
    CompositeLinearFunctional,
    LinearFunctional,
    ScaledLinearFunctional,
    SumLinearFunctional,
)
from ..kernels.base import CovarianceFunction


class ProcessVectorCrossCovariance:
    """Cross-covariance between a random process (free argument) and a
    finite random vector of size ``randvar_size``.

    ``evaluate(x)`` returns ``batch + randproc_output_shape +
    (randvar_size,)`` — randvar axis last, regardless of ``reverse``.
    """

    def __init__(
        self,
        randproc_input_shape,
        randproc_output_shape,
        randvar_size: int,
        reverse: bool = False,
    ):
        self._randproc_input_shape = as_shape(randproc_input_shape)
        self._randproc_output_shape = as_shape(randproc_output_shape)
        self._randvar_size = int(randvar_size)
        self._reverse = bool(reverse)

    @property
    def randproc_input_shape(self) -> ShapeType:
        return self._randproc_input_shape

    @property
    def randproc_input_ndim(self) -> int:
        return len(self._randproc_input_shape)

    @property
    def randproc_output_shape(self) -> ShapeType:
        return self._randproc_output_shape

    @property
    def randvar_size(self) -> int:
        return self._randvar_size

    @property
    def reverse(self) -> bool:
        return self._reverse

    def evaluate(self, x) -> jnp.ndarray:
        raise NotImplementedError

    def __call__(self, x):
        return self.evaluate(jnp.asarray(x))

    def apply_operator(self, op) -> "ProcessVectorCrossCovariance":
        raise NotImplementedError

    def matvec(self, x, w) -> jnp.ndarray:
        """``crosscov(x) @ w`` — subclasses may avoid materializing the
        ``(n_query, randvar_size)`` cross matrix (KeOps-reduction mode)."""
        return self.evaluate(x) @ w

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, ProcessVectorCrossCovariance):
            return SumProcessVectorCrossCovariance(self, other)
        return NotImplemented

    def __rmul__(self, other):
        if np.ndim(other) == 0:
            return ScaledProcessVectorCrossCovariance(self, other)
        return NotImplemented

    __mul__ = __rmul__

    def __neg__(self):
        return -1.0 * self


class KernelFunctionalCrossCov(ProcessVectorCrossCovariance):
    """``x ↦ L_z[k(x, z)]`` (``argnum=1``) or ``x ↦ L_z[k(z, x)]``
    (``argnum=0``), with ``k`` possibly operator-transformed."""

    def __init__(
        self,
        kernel: CovarianceFunction,
        functional: LinearFunctional,
        argnum: int = 1,
    ):
        assert argnum in (0, 1)
        self._kernel = kernel
        self._functional = functional
        self._argnum = argnum
        proc_output = (
            kernel.output_shape_0 if argnum == 1 else kernel.output_shape_1
        )
        super().__init__(
            randproc_input_shape=kernel.input_shape,
            randproc_output_shape=proc_output,
            randvar_size=functional.output_size,
            reverse=(argnum == 0),
        )

    @property
    def kernel(self) -> CovarianceFunction:
        return self._kernel

    @property
    def functional(self) -> LinearFunctional:
        return self._functional

    @property
    def argnum(self) -> int:
        return self._argnum

    def evaluate(self, x):
        return evaluate_crosscov_contraction(
            self._kernel, self._functional, self._argnum, jnp.asarray(x)
        )

    def apply_operator(self, op):
        from ..transforms.dispatch import apply_operator_to_kernel

        proc_slot = 1 - self._argnum
        new_kernel = apply_operator_to_kernel(op, self._kernel, argnum=proc_slot)
        return KernelFunctionalCrossCov(new_kernel, self._functional, self._argnum)


class ScaledProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    def __init__(self, crosscov: ProcessVectorCrossCovariance, scalar):
        if isinstance(crosscov, ScaledProcessVectorCrossCovariance):
            scalar = scalar * crosscov.scalar
            crosscov = crosscov.crosscov
        self.crosscov = crosscov
        self.scalar = float(scalar)
        super().__init__(
            crosscov.randproc_input_shape,
            crosscov.randproc_output_shape,
            crosscov.randvar_size,
            crosscov.reverse,
        )

    def evaluate(self, x):
        return self.scalar * self.crosscov.evaluate(x)

    def apply_operator(self, op):
        return ScaledProcessVectorCrossCovariance(
            self.crosscov.apply_operator(op), self.scalar
        )

    def matvec(self, x, w):
        return self.scalar * self.crosscov.matvec(x, w)


class SumProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    def __init__(self, *summands: ProcessVectorCrossCovariance):
        flat = []
        for s in summands:
            if isinstance(s, SumProcessVectorCrossCovariance):
                flat.extend(s.summands)
            else:
                flat.append(s)
        self.summands = tuple(flat)
        first = flat[0]
        super().__init__(
            first.randproc_input_shape,
            first.randproc_output_shape,
            first.randvar_size,
            first.reverse,
        )

    def evaluate(self, x):
        out = None
        for s in self.summands:
            term = s.evaluate(x)
            out = term if out is None else out + term
        return out

    def apply_operator(self, op):
        return SumProcessVectorCrossCovariance(
            *(s.apply_operator(op) for s in self.summands)
        )

    def matvec(self, x, w):
        out = None
        for s in self.summands:
            term = s.matvec(x, w)
            out = term if out is None else out + term
        return out


class LinOpProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    """``A @ crosscov`` — matrix applied to the randvar axis."""

    def __init__(self, linop, crosscov: ProcessVectorCrossCovariance):
        from ..linalg.linops import aslinop

        self.linop = aslinop(linop)
        self.crosscov = crosscov
        assert self.linop.shape[1] == crosscov.randvar_size
        super().__init__(
            crosscov.randproc_input_shape,
            crosscov.randproc_output_shape,
            self.linop.shape[0],
            crosscov.reverse,
        )

    def evaluate(self, x):
        vals = self.crosscov.evaluate(x)  # ... + (m,)
        return vals @ self.linop.todense().T

    def apply_operator(self, op):
        return LinOpProcessVectorCrossCovariance(
            self.linop, self.crosscov.apply_operator(op)
        )

    def matvec(self, x, w):
        return self.crosscov.matvec(x, self.linop.todense().T @ w)


class ZeroProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    def evaluate(self, x):
        batch = x.shape[: x.ndim - self.randproc_input_ndim]
        return jnp.zeros(
            batch + self.randproc_output_shape + (self.randvar_size,),
            dtype=x.dtype,
        )

    def apply_operator(self, op):
        return ZeroProcessVectorCrossCovariance(
            op.output_domain_shape,
            op.output_codomain_shape,
            self.randvar_size,
            self.reverse,
        )


class ConcatenatedCrossCovariance(ProcessVectorCrossCovariance):
    """Concatenation along the randvar axis — the ``kLas`` container of
    the conditioning engine (reference: ``_conditional.py:112-175``)."""

    def __init__(self, crosscovs):
        crosscovs = tuple(crosscovs)
        first = crosscovs[0]
        assert all(
            c.randproc_input_shape == first.randproc_input_shape
            and c.randproc_output_shape == first.randproc_output_shape
            for c in crosscovs
        )
        self.crosscovs = crosscovs
        super().__init__(
            first.randproc_input_shape,
            first.randproc_output_shape,
            sum(c.randvar_size for c in crosscovs),
            reverse=False,
        )

    def append(self, crosscov) -> "ConcatenatedCrossCovariance":
        return ConcatenatedCrossCovariance(self.crosscovs + (crosscov,))

    def __iter__(self):
        return iter(self.crosscovs)

    def evaluate(self, x):
        return jnp.concatenate(
            [c.evaluate(x) for c in self.crosscovs], axis=-1
        )

    def apply_operator(self, op):
        return ConcatenatedCrossCovariance(
            tuple(c.apply_operator(op) for c in self.crosscovs)
        )

    def matvec(self, x, w):
        out = None
        offset = 0
        for c in self.crosscovs:
            w_c = w[offset : offset + c.randvar_size]
            offset += c.randvar_size
            term = c.matvec(x, w_c)
            out = term if out is None else out + term
        return out


# ---------------------------------------------------------------------------
# Contraction engine
# ---------------------------------------------------------------------------
def evaluate_crosscov_contraction(
    kernel: CovarianceFunction,
    functional: LinearFunctional,
    argnum: int,
    x: jnp.ndarray,
) -> jnp.ndarray:
    """Evaluate ``L`` (on kernel slot ``argnum``) against free points ``x``.

    Returns ``batch + proc_output_shape + (L.output_size,)``.
    """
    # Composite / scaled / sum functionals reduce recursively.
    if isinstance(functional, ScaledLinearFunctional):
        return functional.scalar * evaluate_crosscov_contraction(
            kernel, functional.linfunctl, argnum, x
        )
    if isinstance(functional, SumLinearFunctional):
        out = None
        for s in functional.summands:
            term = evaluate_crosscov_contraction(kernel, s, argnum, x)
            out = term if out is None else out + term
        return out
    if isinstance(functional, CompositeLinearFunctional):
        from ..transforms.dispatch import apply_operator_to_kernel

        k = kernel
        if functional.linfuncop is not None:
            k = apply_operator_to_kernel(
                functional.linfuncop, k, argnum=argnum
            )
        vals = evaluate_crosscov_contraction(k, functional.linfunctl, argnum, x)
        if functional.linop is not None:
            vals = vals @ functional.linop.todense().T
        return vals

    # Exact closed-form integral crosscovs (reference parity:
    # ``crosscov/linfunctls/integrals/_matern_lebesgue.py``).
    from ..transforms.integrals_exact import exact_integral_hooks

    hook = exact_integral_hooks(kernel, functional)
    if hook is not None:
        crosscov_fn, _ = hook
        return crosscov_fn(x)[..., None]

    # Exact hat-basis projection crosscovs (reference carries ν=3/2 only,
    # ``crosscov/linfunctls/projections.py:131``; all half-integer ν here).
    from ..transforms.integrals_exact import exact_projection_crosscov

    proj_fn = exact_projection_crosscov(kernel, functional)
    if proj_fn is not None:
        return proj_fn(x)

    disc = functional.discretization()
    pts = disc.points  # (nq,) + domain
    in_ndim = kernel.input_ndim
    batch_ndim = x.ndim - in_ndim
    batch = x.shape[:batch_ndim]

    # Fast path for scalar-output kernels: the contraction is a Gram
    # (n, nq) — route through gram_matrix (native engine / fused XLA).
    if kernel.output_shape_0 == () and kernel.output_shape_1 == ():
        from ..gram import gram_matrix

        x_flat = x.reshape((-1,) + kernel.input_shape)
        if argnum == 1:
            G = gram_matrix(kernel, x_flat, pts)  # (n, nq)
        else:
            G = gram_matrix(kernel, pts, x_flat).T  # (n, nq)
        if disc.weights is not None:
            G = G @ jnp.asarray(disc.weights).T
        return G.reshape(batch + (G.shape[-1],))

    # Broadcast: free points get a trailing singleton batch axis, the
    # functional points broadcast against it.
    xx = x[(Ellipsis, None) + (slice(None),) * in_ndim]
    if argnum == 1:
        vals = kernel._evaluate(xx, pts)
    else:
        vals = kernel._evaluate(pts, xx)
    # vals: batch + (nq,) + out0 + out1
    out0, out1 = kernel.output_shape_0, kernel.output_shape_1
    proc_out = out0 if argnum == 1 else out1
    func_out = out1 if argnum == 1 else out0
    return _contract_functional_axis(
        vals, batch_ndim, proc_out, func_out, argnum, disc
    )


def _contract_functional_axis(vals, batch_ndim, proc_out, func_out, argnum, disc):
    """Contract the ``(nq,) + func_out`` axes of a pairwise evaluation.

    ``vals``: ``batch + (nq,) + out0 + out1`` where the functional slot's
    codomain is ``func_out`` and the process slot's is ``proc_out``.
    """
    nq = vals.shape[batch_ndim]
    p, f = len(proc_out), len(func_out)
    # Identify axis positions of out0/out1 after the nq axis.
    if argnum == 1:
        # layout: batch, nq, proc_out, func_out
        perm = (
            tuple(range(batch_ndim))  # batch
            + tuple(range(batch_ndim + 1, batch_ndim + 1 + p))  # proc_out
            + (batch_ndim,)  # nq
            + tuple(range(batch_ndim + 1 + p, batch_ndim + 1 + p + f))  # func_out
        )
    else:
        # layout: batch, nq, func_out, proc_out
        perm = (
            tuple(range(batch_ndim))
            + tuple(range(batch_ndim + 1 + f, batch_ndim + 1 + f + p))  # proc_out
            + (batch_ndim,)  # nq
            + tuple(range(batch_ndim + 1, batch_ndim + 1 + f))  # func_out
        )
    vals = jnp.transpose(vals, perm)
    # Now: batch + proc_out + (nq,) + func_out
    lead = vals.shape[: batch_ndim + p]
    func_size = size(func_out)

    if disc.weights is None:
        if func_out == () or not disc.codomain_first:
            # batch-first flattening: (nq, func_out) C-order.
            return vals.reshape(lead + (nq * func_size,))
        # codomain-first: (func_out, nq).
        vals = jnp.moveaxis(
            vals.reshape(lead + (nq, func_size)), -1, -2
        )
        return vals.reshape(lead + (func_size * nq,))

    flat = vals.reshape(lead + (nq * func_size,))
    return flat @ jnp.asarray(disc.weights).T


def apply_functional_to_crosscov(
    functional: LinearFunctional, crosscov: ProcessVectorCrossCovariance
):
    """Contract a functional over the free process slot of a crosscov,
    producing the dense Gram block ``(functional.output_size,
    crosscov.randvar_size)`` wrapped in a ``Covariance`` view."""
    from ..linalg.covariance import Covariance

    if isinstance(functional, ScaledLinearFunctional):
        inner = apply_functional_to_crosscov(functional.linfunctl, crosscov)
        return Covariance(
            functional.scalar * inner.array, inner.shape0, inner.shape1
        )
    if isinstance(functional, SumLinearFunctional):
        total = None
        for s in functional.summands:
            term = apply_functional_to_crosscov(s, crosscov)
            total = term if total is None else Covariance(
                total.array + term.array, total.shape0, total.shape1
            )
        return total
    if isinstance(functional, CompositeLinearFunctional):
        cc = crosscov
        if functional.linfuncop is not None:
            cc = cc.apply_operator(functional.linfuncop)
        inner = apply_functional_to_crosscov(functional.linfunctl, cc)
        if functional.linop is not None:
            mat = functional.linop.todense() @ inner.matrix
            return Covariance(
                mat, functional.output_shape, (crosscov.randvar_size,)
            )
        return inner

    # Exact ``∫∫ k`` Gram entries for matching Matérn integral pairs.
    if isinstance(crosscov, KernelFunctionalCrossCov):
        from ..functionals.integrals import LebesgueIntegral
        from ..transforms.integrals_exact import (
            exact_integral_hooks,
            exact_projection_gram,
        )

        if (
            isinstance(functional, LebesgueIntegral)
            and isinstance(crosscov.functional, LebesgueIntegral)
            and functional.domain == crosscov.functional.domain
        ):
            hook = exact_integral_hooks(crosscov.kernel, crosscov.functional)
            if hook is not None:
                _, gram_value = hook
                return Covariance(
                    jnp.asarray([[gram_value]]),
                    functional.output_shape,
                    (1,),
                )

        # Exact hat-basis double-projection Gram blocks (closed form for
        # every half-integer ν; the reference's exact projection formulas
        # stop at the crosscov level, ``crosscov/linfunctls/projections.py``).
        blk = exact_projection_gram(functional, crosscov)
        if blk is not None:
            return Covariance(
                blk, functional.output_shape, (crosscov.randvar_size,)
            )

    disc = functional.discretization()
    vals = crosscov.evaluate(disc.points)
    # vals: (nq,) + proc_out + (m,)
    m = crosscov.randvar_size
    nq = disc.num_points
    proc_size = size(crosscov.randproc_output_shape)

    if disc.weights is None:
        codomain_first = getattr(functional, "codomain_first", True)
        if crosscov.randproc_output_shape == () or not codomain_first:
            block = vals.reshape(nq * proc_size, m)
        else:
            block = jnp.moveaxis(
                vals.reshape(nq, proc_size, m), 1, 0
            ).reshape(proc_size * nq, m)
    else:
        flat = vals.reshape(nq * proc_size, m)
        block = jnp.asarray(disc.weights) @ flat
    return Covariance(block, functional.output_shape, (m,))
