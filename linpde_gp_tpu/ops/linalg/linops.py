"""Structured linear operators.

Subsumes the probnum linop lattice the reference depends on
(``pn.linops.{Matrix, Identity, Zero, Kronecker, BlockDiagonalMatrix}``,
see SURVEY.md L1) plus the reference's own ``BlockMatrix`` /
``ConcatenatedLinearOperator`` (``linops/_block.py``,
``linops/_concatenated.py``) — as a small tagged hierarchy of JAX-native
operators.  Every operator can densify (``todense``) and apply
(``__matmul__``); structured types override the hot paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LinearOperator",
    "Dense",
    "Identity",
    "Zero",
    "Scalar",
    "Diagonal",
    "Kronecker",
    "BlockDiagonal",
    "Block",
    "aslinop",
]


class LinearOperator:
    """Base class: shape ``(m, n)`` linear map."""

    def __init__(self, shape, dtype=None):
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = dtype

    def todense(self) -> jnp.ndarray:
        raise NotImplementedError

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return Dense(self.todense() @ other.todense())
        if not isinstance(other, (np.ndarray, jnp.ndarray, list, tuple, float, int)):
            return NotImplemented  # e.g. LinearFunctional handles __rmatmul__
        other = jnp.asarray(other)
        return self._matmul(other)

    def __rmatmul__(self, other):
        other = jnp.asarray(other)
        return (self.T._matmul(other.T)).T if other.ndim == 2 else self.T._matmul(other)

    def _matmul(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.todense() @ x

    @property
    def T(self) -> "LinearOperator":
        return Dense(self.todense().T)

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return Dense(self.todense() + other.todense())
        return Dense(self.todense() + jnp.asarray(other))

    __radd__ = __add__

    def __mul__(self, scalar):
        return Dense(self.todense() * scalar)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)

    def diagonal(self) -> jnp.ndarray:
        return jnp.diagonal(self.todense())

    # -- probnum-parity solve surface (``pn.linops.LinearOperator.solve``
    #    / ``.inv()`` / ``.cholesky()``, SURVEY.md L1) ------------------
    def solve(self, b) -> jnp.ndarray:
        """Solve ``A x = b`` (dense LU; SPD-structured subclasses use
        Cholesky)."""
        b = jnp.asarray(b)
        return jnp.linalg.solve(self.todense(), b)

    def cholesky(self, lower: bool = True) -> jnp.ndarray:
        from .chol import cholesky as _chol

        chol = _chol(self.todense())
        return chol if lower else chol.T

    def inv(self) -> "LinearOperator":
        return Dense(jnp.linalg.inv(self.todense()))


class Dense(LinearOperator):
    def __init__(self, array):
        self.array = jnp.asarray(array)
        assert self.array.ndim == 2
        super().__init__(self.array.shape, self.array.dtype)

    def todense(self):
        return self.array

    def _matmul(self, x):
        return jnp.matmul(self.array, x, precision=jax.lax.Precision.HIGHEST)

    @property
    def T(self):
        return Dense(self.array.T)

    def __mul__(self, scalar):
        return Dense(self.array * scalar)

    __rmul__ = __mul__


class Identity(LinearOperator):
    def __init__(self, n, dtype=None):
        super().__init__((n, n), dtype)

    def todense(self):
        return jnp.eye(self.shape[0], dtype=self.dtype)

    def _matmul(self, x):
        return x

    @property
    def T(self):
        return self

    def diagonal(self):
        return jnp.ones((self.shape[0],), dtype=self.dtype)


class Zero(LinearOperator):
    def todense(self):
        return jnp.zeros(self.shape, dtype=self.dtype)

    def _matmul(self, x):
        return jnp.zeros(self.shape[:1] + x.shape[1:], dtype=x.dtype)

    @property
    def T(self):
        return Zero((self.shape[1], self.shape[0]), self.dtype)

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return other
        return Dense(jnp.broadcast_to(jnp.asarray(other), self.shape))

    __radd__ = __add__

    def diagonal(self):
        return jnp.zeros((min(self.shape),), dtype=self.dtype)


class Scalar(LinearOperator):
    """``alpha * I``."""

    def __init__(self, n, alpha):
        self.alpha = jnp.asarray(alpha)
        super().__init__((n, n), self.alpha.dtype)

    def todense(self):
        return self.alpha * jnp.eye(self.shape[0], dtype=self.alpha.dtype)

    def _matmul(self, x):
        return self.alpha * x

    @property
    def T(self):
        return self

    def diagonal(self):
        return jnp.full((self.shape[0],), self.alpha)


class Diagonal(LinearOperator):
    def __init__(self, diag):
        self.diag = jnp.asarray(diag)
        super().__init__((self.diag.shape[0],) * 2, self.diag.dtype)

    def todense(self):
        return jnp.diag(self.diag)

    def _matmul(self, x):
        return self.diag[:, None] * x if x.ndim == 2 else self.diag * x

    @property
    def T(self):
        return self

    def diagonal(self):
        return self.diag


class Kronecker(LinearOperator):
    """``A ⊗ B`` — the Gram structure of tensor-product kernels on
    ``TensorProductGrid``s (reference: ``covfuncs/_tensor_product.py:64-82``,
    backed by ``pn.linops.Kronecker``)."""

    def __init__(self, A: LinearOperator, B: LinearOperator):
        self.A = aslinop(A)
        self.B = aslinop(B)
        super().__init__(
            (self.A.shape[0] * self.B.shape[0], self.A.shape[1] * self.B.shape[1]),
            self.B.dtype,
        )

    def todense(self):
        a = self.A.todense()
        b = self.B.todense()
        return jnp.einsum("ij,kl->ikjl", a, b).reshape(self.shape)

    def _matmul(self, x):
        # (A ⊗ B) vec_C(X) with C-order flattening: reshape to (a_cols, b_cols)
        a_rows, b_rows = self.A.shape[0], self.B.shape[0]
        a_cols, b_cols = self.A.shape[1], self.B.shape[1]
        vector = x.ndim == 1
        if vector:
            x = x[:, None]
        n_rhs = x.shape[1]
        xt = x.reshape(a_cols, b_cols, n_rhs)
        # Apply B on middle axis, A on first axis.
        # Explicit HIGHEST precision: a default-precision f32 einsum may
        # run in TF32/bf16 passes (~2e-3 relative on a 96-contraction —
        # enough to make honest-noise grid CG stall); do not rely on the
        # global matmul-precision flag.
        hi = jax.lax.Precision.HIGHEST
        xt = jnp.einsum("bk,akr->abr", self.B.todense(), xt, precision=hi)
        out = jnp.einsum("ca,abr->cbr", self.A.todense(), xt, precision=hi)
        out = out.reshape(a_rows * b_rows, n_rhs)
        return out[:, 0] if vector else out

    @property
    def T(self):
        return Kronecker(self.A.T, self.B.T)

    def __mul__(self, scalar):
        return Kronecker(self.A * scalar, self.B)

    __rmul__ = __mul__

    def diagonal(self):
        return jnp.kron(self.A.diagonal(), self.B.diagonal())


class BlockDiagonal(LinearOperator):
    def __init__(self, blocks):
        self.blocks = [aslinop(b) for b in blocks]
        m = sum(b.shape[0] for b in self.blocks)
        n = sum(b.shape[1] for b in self.blocks)
        super().__init__((m, n), self.blocks[0].dtype)

    def todense(self):
        out = jnp.zeros(self.shape, dtype=self.blocks[0].todense().dtype)
        i = j = 0
        for b in self.blocks:
            d = b.todense()
            out = out.at[i : i + d.shape[0], j : j + d.shape[1]].set(d)
            i += d.shape[0]
            j += d.shape[1]
        return out

    @property
    def T(self):
        return BlockDiagonal([b.T for b in self.blocks])

    def diagonal(self):
        return jnp.concatenate([b.diagonal() for b in self.blocks])


class SumOperator(LinearOperator):
    """``A_1 + ... + A_m`` kept structured (e.g. sums of Kronecker
    products from operator-transformed tensor-product kernels on grids,
    reference ``covfuncs/linfuncops/diffops/_tensor_product.py:140-156``)."""

    def __init__(self, *summands: "LinearOperator"):
        flat = []
        for s in summands:
            if isinstance(s, SumOperator):
                flat.extend(s.summands)
            else:
                flat.append(aslinop(s))
        self.summands = flat
        super().__init__(flat[0].shape, flat[0].dtype)

    def todense(self):
        out = self.summands[0].todense()
        for s in self.summands[1:]:
            out = out + s.todense()
        return out

    def _matmul(self, x):
        out = self.summands[0]._matmul(x)
        for s in self.summands[1:]:
            out = out + s._matmul(x)
        return out

    @property
    def T(self):
        return SumOperator(*(s.T for s in self.summands))

    def __mul__(self, scalar):
        return SumOperator(*(s * scalar for s in self.summands))

    __rmul__ = __mul__

    def diagonal(self):
        out = self.summands[0].diagonal()
        for s in self.summands[1:]:
            out = out + s.diagonal()
        return out


class Block(LinearOperator):
    """General block matrix from a 2-D grid of operators (reference:
    ``linops/_block.py:17-82``)."""

    def __init__(self, blocks):
        self.blocks = [[aslinop(b) for b in row] for row in blocks]
        m = sum(row[0].shape[0] for row in self.blocks)
        n = sum(b.shape[1] for b in self.blocks[0])
        super().__init__((m, n), self.blocks[0][0].dtype)

    def todense(self):
        return jnp.concatenate(
            [
                jnp.concatenate([b.todense() for b in row], axis=1)
                for row in self.blocks
            ],
            axis=0,
        )

    @property
    def T(self):
        transposed = [
            [self.blocks[i][j].T for i in range(len(self.blocks))]
            for j in range(len(self.blocks[0]))
        ]
        return Block(transposed)


def aslinop(x) -> LinearOperator:
    if isinstance(x, LinearOperator):
        return x
    arr = jnp.asarray(x)
    if arr.ndim == 0:
        raise ValueError("Cannot convert a scalar to a linear operator.")
    if arr.ndim == 1:
        return Diagonal(arr)
    return Dense(arr)
