"""One-shot distributed conditioning: sharded Gram → padded distributed
Cholesky → distributed solve.

Arbitrary N is handled by padding the Gram with an identity block (the
factor of ``blockdiag(K, I)`` is ``blockdiag(chol(K), I)``, and zero-
padded right-hand sides stay zero through both triangular solves).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..config import config
from .cholesky import (
    distributed_chol_solve,
    distributed_cholesky,
    distributed_cholesky_2d,
    distributed_cholesky_cyclic,
)
from .extend import DistributedCholFactor
from .gram import sharded_gram


def _pad_multiple(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


def _factorize(gram, *, mesh: Mesh, block_size: int, layout: str = "auto"):
    """Route the distributed factorization (north-star "2-D mesh" mandate):

    - 2-D block-cyclic (``distributed_cholesky_2d``, O(n²/Pr) comm per
      device) on 2-D meshes with P >= 4 and Pr | Pc — the default at
      pod-relevant device counts AT ANY SIZE: exact-width unrolled body
      up to 128 block-columns, masked fori_loop body above (the N=1e5 /
      391-block regime routes 2-D);
    - 1-D block-cyclic for small meshes (its n³/(3P) per-device FLOPs at
      a single panel broadcast per step beats the 2-D routing overhead
      when the panel all-gather is not the bottleneck);
    - masked fori_loop contiguous variant otherwise.
    """
    n = gram.shape[0]
    nblocks = n // block_size
    names = mesh.axis_names
    if layout == "auto":
        two_d_ok = (
            len(names) == 2
            and mesh.devices.size >= 4
            and mesh.shape[names[1]] % mesh.shape[names[0]] == 0
            and n % (block_size * mesh.shape[names[0]]) == 0
            and n % (block_size * mesh.shape[names[1]]) == 0
        )
        if two_d_ok:
            layout = "2d"
        elif nblocks <= 128:
            layout = "cyclic"
        else:
            layout = "contiguous"
    if layout == "2d":
        return distributed_cholesky_2d(gram, mesh=mesh, block_size=block_size)
    if layout == "cyclic" and nblocks <= 128:
        return distributed_cholesky_cyclic(gram, mesh=mesh, block_size=block_size)
    return distributed_cholesky(gram, mesh=mesh, block_size=block_size)


def distributed_condition(
    kernel,
    X,
    Y,
    *,
    mesh: Mesh,
    noise_variance: float = 0.0,
    block_size: int = 256,
    jitter: float | None = None,
    layout: str = "auto",
):
    """Compute representer weights ``(K + sigma^2 I)^{-1} (Y)`` with every
    stage sharded over the mesh.

    ``layout="auto"`` (default) routes through :func:`_factorize`: the
    2-D block-cyclic factorization (O(n²/Pr) comm) on 2-D meshes with
    P >= 4, the 1-D block-cyclic otherwise (``n³/(3P)`` FLOPs per device
    — the parallel ideal), the masked fori_loop row-slab variant above
    128 block-columns; ``"2d"``/``"cyclic"``/``"contiguous"`` force one.

    Returns ``(weights, chol)`` with ``chol`` row-sharded (padded size).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y).reshape(-1)
    n = Y.shape[0]
    num_devices = mesh.devices.size
    quantum = num_devices * block_size
    n_pad = _pad_multiple(max(n, quantum), quantum)

    gram = sharded_gram(kernel, X, mesh=mesh)
    if jitter is None:
        jitter = config.cholesky_jitter
    diag_bump = noise_variance + jitter
    if diag_bump:
        gram = gram + diag_bump * jnp.eye(n, dtype=gram.dtype)

    if n_pad != n:
        padded = jnp.eye(n_pad, dtype=gram.dtype)
        padded = padded.at[:n, :n].set(gram)
        gram = padded
        Y = jnp.concatenate([Y, jnp.zeros(n_pad - n, Y.dtype)])

    chol = _factorize(gram, mesh=mesh, block_size=block_size, layout=layout)
    weights = distributed_chol_solve(chol, Y, mesh=mesh, block_size=block_size)
    return weights[:n], chol


class DistributedConditioner:
    """Incremental distributed GP conditioning: the N×N base Gram is
    factorized ONCE on the mesh; each further observation batch is a
    Schur extension (multi-RHS distributed forward solve + small
    replicated Cholesky) — the mesh-scale generalization of the
    reference's "condition again without refactoring" property
    (``linops/_block.py:226-268``; SURVEY §7 hard part #3).

    Batches may use DIFFERENT operator-transformed kernels; the caller
    supplies, per new batch, the cross kernel against each previous
    batch (``L_i k L_new*``) and the new diagonal kernel
    (``L_new k L_new*``), exactly as the dense engine's dispatch does.
    """

    def __init__(self, *, mesh: Mesh, block_size: int = 256):
        self.mesh = mesh
        self.block_size = int(block_size)
        self._factor: DistributedCholFactor | None = None
        self._Xs: list = []
        self._resids: list = []
        self._n_pad = 0
        self._n0 = 0

    @property
    def num_batches(self) -> int:
        return len(self._Xs)

    def condition(self, kernel, X, Y, *, noise_variance: float = 0.0,
                  jitter: float | None = None):
        """Factorize the first (large) batch; returns the representer
        weights for it."""
        assert self._factor is None, "already conditioned; use extend()"
        X = jnp.asarray(X)
        Y = jnp.asarray(Y).reshape(-1)
        n = Y.shape[0]
        quantum = self.mesh.devices.size * self.block_size
        n_pad = _pad_multiple(max(n, quantum), quantum)

        gram = sharded_gram(kernel, X, mesh=self.mesh)
        if jitter is None:
            jitter = config.cholesky_jitter
        bump = noise_variance + jitter
        if bump:
            gram = gram + bump * jnp.eye(n, dtype=gram.dtype)
        if n_pad != n:
            padded = jnp.eye(n_pad, dtype=gram.dtype)
            padded = padded.at[:n, :n].set(gram)
            gram = padded

        chol = _factorize(gram, mesh=self.mesh, block_size=self.block_size)
        self._factor = DistributedCholFactor(
            chol, mesh=self.mesh, block_size=self.block_size
        )
        self._Xs = [X.reshape((-1,) + X.shape[X.ndim - kernel.input_ndim:])]
        self._n0 = n
        self._n_pad = n_pad
        self._resids = [jnp.concatenate([Y, jnp.zeros(n_pad - n, Y.dtype)])]
        return self.weights()

    def extend(self, cross_kernels, diag_kernel, X_new, Y_new, *,
               noise_variance: float = 0.0, jitter: float | None = None):
        """Append an observation batch without refactorizing.

        ``cross_kernels``: one kernel per existing batch, evaluating
        ``L_i k L_new*``; ``diag_kernel``: ``L_new k L_new*``.
        """
        assert self._factor is not None, "call condition() first"
        X_new = jnp.asarray(X_new)
        Y_new = jnp.asarray(Y_new).reshape(-1)
        m = Y_new.shape[0]
        from ..ops.gram import gram_matrix

        def gram_block(kernel, X0, X1):
            # Extension batches are usually small; shard only when the
            # point counts divide the mesh axes, else assemble dense.
            # 1-D meshes shard rows only (sharded_gram handles both).
            names = self.mesh.axis_names
            r_div = self.mesh.shape[names[0]]
            c_div = self.mesh.shape[names[1]] if len(names) > 1 else 1
            n0 = X0.reshape((-1,) + kernel.input_shape).shape[0]
            n1 = X1.reshape((-1,) + kernel.input_shape).shape[0]
            if n0 % r_div == 0 and n1 % c_div == 0:
                return sharded_gram(kernel, X0, X1, mesh=self.mesh)
            return gram_matrix(
                kernel,
                jnp.asarray(X0).reshape((-1,) + kernel.input_shape),
                jnp.asarray(X1).reshape((-1,) + kernel.input_shape),
            )

        blocks = []
        for i, (k_cross, X_old) in enumerate(zip(cross_kernels, self._Xs)):
            C = gram_block(k_cross, X_old, X_new)
            if i == 0 and self._n_pad != self._n0:
                C = jnp.concatenate(
                    [C, jnp.zeros((self._n_pad - self._n0, m), C.dtype)], axis=0
                )
            blocks.append(C)
        B = jnp.concatenate(blocks, axis=0)
        D = jnp.asarray(gram_block(diag_kernel, X_new, X_new))
        if jitter is None:
            jitter = config.cholesky_jitter
        bump = noise_variance + jitter
        if bump:
            D = D + bump * jnp.eye(m, dtype=D.dtype)
        self._factor.extend(B, D)
        self._Xs.append(X_new.reshape(
            (-1,) + X_new.shape[X_new.ndim - diag_kernel.input_ndim:]
        ))
        self._resids.append(Y_new)
        return self.weights()

    def weights(self) -> jnp.ndarray:
        """Representer weights for all batches (padding rows stripped)."""
        w = self._weights_full()
        return jnp.concatenate([w[: self._n0], w[self._n_pad :]])

    def _weights_full(self) -> jnp.ndarray:
        """Weights in the factor's internal (padded) row layout."""
        rhs = jnp.concatenate(self._resids)
        return self._factor.solve(rhs)

    def posterior_eval(
        self,
        cross_kernels,
        prior_kernel,
        Xq,
        *,
        with_std: bool = True,
        query_block_size: int = 1024,
    ):
        """Posterior mean (and std) at query points, backed by the
        MESH-SHARDED factor: the std update solves ``L y = U`` through
        :func:`distributed_tri_solve` (multi-RHS) against the row-sharded
        base block plus the Schur-extension chain — the factor is never
        replicated or refactorized (reference equivalent:
        ``_conditional.py:223-251``, which triangular-solves against the
        cached block Cholesky).

        ``cross_kernels``: one kernel per conditioned batch, evaluating
        ``L_i k`` — i.e. ``k_i(X_i, xq)`` blocks; ``prior_kernel``: the
        plain prior kernel (pointwise variance).  Assumes a zero-mean
        prior (the conditioner's residual convention).
        """
        assert self._factor is not None, "call condition() first"
        from ..ops.gram import gram_matrix

        in_shape = prior_kernel.input_shape
        Xq = jnp.asarray(Xq).reshape((-1,) + in_shape)
        nq = Xq.shape[0]
        w = self._weights_full()

        # The query axis is processed in bounded blocks so the cross
        # workspace is O(size * query_block_size), never the replicated
        # (size, nq) buffer (SURVEY §5
        # "points"-axis sharding; reference analog: the batched eval
        # paths of ``_conditional.py:223-251``).
        bq = min(int(query_block_size), nq)
        means, stds = [], []
        for start in range(0, nq, bq):
            Xq_blk = Xq[start : start + bq]
            nb_q = Xq_blk.shape[0]
            blocks = []
            for i, (k_c, X_i) in enumerate(zip(cross_kernels, self._Xs)):
                C = gram_matrix(k_c, X_i, Xq_blk)  # (n_i, nb_q)
                if i == 0 and self._n_pad != self._n0:
                    C = jnp.concatenate(
                        [C, jnp.zeros((self._n_pad - self._n0, nb_q), C.dtype)],
                        axis=0,
                    )
                blocks.append(C)
            U = jnp.concatenate(blocks, axis=0)  # (size, nb_q)
            means.append(U.T @ w)
            if with_std:
                y = self._factor._solve_lower(U)  # distributed multi-RHS
                var_update = jnp.sum(y**2, axis=0)
                prior_var = prior_kernel(Xq_blk)
                stds.append(jnp.sqrt(jnp.maximum(prior_var - var_update, 0.0)))
        mean = jnp.concatenate(means)
        if not with_std:
            return mean
        return mean, jnp.concatenate(stds)
