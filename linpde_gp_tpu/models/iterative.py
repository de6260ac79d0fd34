"""Gram-free iterative GP conditioning.

Beyond-reference scale capability: at N ≳ 5·10^4 the dense Gram
(O(N²) device memory) no longer fits on a card.  This solver never
materializes it — representer weights are computed by conjugate
gradients where each Gram matvec streams through the kernel reduction
routed by ``ops/gram.gram_matvec``: O(N²) compute, O(N) memory.
This is the reference's KeOps strategy ("O(N²) compute without O(N²)
memory", SURVEY.md §5) applied to the full solve, not just assembly.

Posterior variance solves ``K^{-1} k(x_q)`` per query block with the
same matvec (batched CG via ``vmap``), so it is exact up to the CG
tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.linalg.pcg import (
    NystromPreconditioner,
    landmark_indices,
    make_pcg_ff_programs,
    nystrom_preconditioner,
    nystrom_preconditioner_device,
    nystrom_preconditioner_hybrid,
    make_pcg_block_ff_programs,
    pcg,
    pcg_block,
    pcg_block_ff,
    pcg_block_host,
    pcg_ff,
    pcg_host,
)
from .. import backend
from ..ops.gram import (
    compact_support_radius,
    gram_matrix,
    gram_matvec,
    kernel_term_specs,
    make_banded_matvec,
    terms_gram,
)
from ..ops.transforms.dispatch import apply_operator_to_kernel
from .functions.base import Function, Zero
from .gp import GaussianProcess


def _mm(a, b):
    """Matrix product at full precision (never TF32 for float32)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@jax.jit
def _apply_preconditioner(M, r):
    """Preconditioner apply with ``M`` (a NamedTuple pytree) as a jit
    ARGUMENT: closure-capturing it instead would bake the rank-m factor
    (3.3 GB in float64 at N=1e5/m=4096) into the XLA program as a
    constant."""
    return M(r)


class IterativeGPRegressor:
    """Condition a scalar GP on one combined operator-observation set,
    gram-free.

    Parameters
    ----------
    prior:
        Scalar-output :class:`GaussianProcess`.
    X:
        ``(n,) + input_shape`` collocation points.
    Y:
        ``(n,)`` observations of ``L u (x_i) + eps``.
    L:
        Optional linear differential operator applied to ``u`` at ``X``.
    noise_variance:
        Homoscedastic observation noise (also the regularizer; must be
        positive for CG conditioning of smooth-kernel Grams).
    precond_rank:
        Rank of the Nyström preconditioner (``ops/linalg/pcg.py``).
        ``"auto"`` picks 0 for small problems and ``min(512, n // 4)``
        above 1,024 observations; ``0`` disables preconditioning.
        Smooth-kernel Grams have fast-decaying spectra, so a modest rank
        collapses the CG iteration count from hundreds to tens at an
        O(n·m²) one-off matmul cost.

    Examples
    --------
    >>> import numpy as np, jax.numpy as jnp
    >>> import linpde_gp_tpu as lgt
    >>> prior = lgt.GaussianProcess(
    ...     lgt.functions.Zero(()), lgt.kernels.Matern((), nu=2.5))
    >>> X = np.linspace(-1.0, 1.0, 32)
    >>> reg = IterativeGPRegressor(
    ...     prior, X, np.sin(3.0 * X), noise_variance=1e-8, tol=1e-12)
    >>> bool(abs(float(reg.mean(jnp.asarray(0.5))) - np.sin(1.5)) < 1e-4)
    True
    """

    def __init__(
        self,
        prior: GaussianProcess,
        X,
        Y,
        *,
        L=None,
        noise_variance: float = 1e-6,
        tol: float = 1e-6,
        maxiter: int = 512,
        precond_rank: int | str = "auto",
        compensated: bool | None = None,
        host_cg: bool | None = None,
        device_cg: bool = False,
        precond_build: str = "auto",
        anchor_X=None,
        anchor_Y=None,
        anchor_noise: float = 1e-8,
    ):
        """``anchor_X``/``anchor_Y``: an optional SMALL second batch of
        plain evaluation observations ``u(x) + eps`` (initial/boundary
        conditions of a PDE problem) conditioned JOINTLY with the large
        operator batch — the gram-free analogue of the reference's
        multi-batch conditioning (``_conditional.py``; its heat-1D
        experiment conditions on IC + BC + PDE).  Solved by block
        elimination: the dense anchor block ``A11 = k(X1,X1) + s1^2 I``
        is factorized once (O(n1^3), n1 small), and CG runs on the
        SPD Schur complement ``S = A22 - W A11^{-1} W^T`` whose matvec
        is the streaming O(N^2) reduction plus two thin (N, n1) GEMMs.
        """
        if prior.output_shape != ():
            raise ValueError("IterativeGPRegressor supports scalar outputs.")
        self.prior = prior
        self.X = jnp.asarray(X).reshape((-1,) + prior.input_shape)
        self.Y = jnp.asarray(Y).reshape(-1)
        self.noise_variance = float(noise_variance)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        # Compensated (float-float) streaming evaluation: required for
        # small noise at large N in float32 — the plain f32 chain's
        # coherent error makes the Gram-as-operator indefinite once
        # sigma^2 < ~1e-6 * n * k(0) (ops/ff.py).  None defers to
        # config.gram_compensated.
        from ..config import config as _config

        self.compensated = (
            _config.gram_compensated if compensated is None else bool(compensated)
        )
        # Host-orchestrated CG (config.host_cg): the weights solve calls
        # separately jitted matvec / preconditioner-apply programs from a
        # host loop instead of one fused lax.while_loop program, with the
        # CG vector arithmetic in host float64 (ops/linalg/pcg.pcg_host).
        self.host_cg = _config.host_cg if host_cg is None else bool(host_cg)
        # Device-state CG (ops/linalg/pcg.pcg_ff): CG vectors
        # live on device as float-float pairs, two fused programs and
        # scalar-only host traffic per iteration — the low-dispatch path
        # for CHEAP matvecs (sum-of-Kronecker grids, banded kernels)
        # where pcg_host's per-iteration copies would dominate.
        self.device_cg = bool(device_cg)
        # "hybrid": host-f64-factorized streamed Nystrom build with
        # device-precision floors (see nystrom_preconditioner_hybrid) —
        # stronger than the legacy all-device build at large n/m, and it
        # never materializes the (n, m) block.
        # "device": same floors, all factorizations on device, scalar-only
        # host traffic.
        if precond_build not in ("auto", "legacy", "hybrid", "device"):
            raise ValueError(f"unknown precond_build: {precond_build!r}")
        self.precond_build = precond_build
        self._ff_programs = None

        k = prior.cov
        if L is not None:
            k_obs = apply_operator_to_kernel(
                L, apply_operator_to_kernel(L, k, argnum=1), argnum=0
            )
            k_cross = apply_operator_to_kernel(L, k, argnum=1)
            mean_obs = L(prior.mean) if not isinstance(prior.mean, Zero) else prior.mean
        else:
            k_obs = k
            k_cross = k
            mean_obs = prior.mean
        self._k_obs = k_obs
        self._k_cross = k_cross
        self._mean_obs = mean_obs

        self._obs_spec = kernel_term_specs(k_obs)
        self._cross_spec = kernel_term_specs(k_cross)

        # Sum-of-Kronecker Gram matvecs on tensor-product grids: for an
        # (n_1 × ... × n_d) grid the structured matvec costs
        # O(N · Σ n_i) instead of O(N²) — the reference's Kronecker
        # shortcut (``covfuncs/_tensor_product.py:64-82``) applied to the
        # whole iterative solve.  C-order grid flattening matches the
        # Kronecker vec convention.
        self._gram_linop = None
        self._kron_ff = None
        from .domains.grid import grid_factors
        from ..ops.linalg.linops import Dense

        if grid_factors(X) is not None:
            try:
                linop = k_obs.linop(X)
            except NotImplementedError:
                linop = None
            if linop is not None and not isinstance(linop, Dense):
                self._gram_linop = linop
            # Compensated grid matvec: the PLAIN f32 sum-of-Kronecker
            # evaluation carries ~600*eps32 coherent error from term
            # cancellation (measured ||E v||/||v|| ~ 7e-2 at a (200,100)
            # heat grid — 140x a 1e-3-relative nugget), so honest-noise
            # conditioning on grids needs the float-float tables+GEMMs
            # of ops/kron_ff.py whenever compensation is on.
            if (
                self.compensated
                and self._obs_spec is not None
                and len(grid_factors(X)) == 2
            ):
                try:
                    from ..ops.kron_ff import KronFFMatvec

                    self._kron_ff = KronFFMatvec(
                        self._obs_spec, grid_factors(X)
                    )
                except NotImplementedError:
                    self._kron_ff = None

        # Compact-support routing (Wendland family): when every term's
        # dim-0 factor vanishes beyond a radius, the Gram matvec visits
        # only the O(band) column tiles inside the support window —
        # O(N * band) pair work instead of O(N^2) (the structural
        # sparsity the reference never exploits; its Wendland goes
        # through the same dense KeOps reduction as everything else,
        # ``covfuncs/_wendland.py:23-29``).  The band schedule needs the
        # CONCRETE points, which the constructor has.
        self._banded = None
        if self._gram_linop is None and self._obs_spec is not None:
            _scale, _terms = self._obs_spec
            n_obs = self.X.shape[0]
            if backend.route(
                "matvec",
                n0=n_obs,
                n1=n_obs,
                compact=compact_support_radius(_terms, 0) is not None,
            ) == "banded":
                banded = make_banded_matvec(
                    self._obs_spec,
                    np.asarray(self.X.reshape(self.X.shape[0], -1)),
                    np.asarray(self.X.reshape(self.X.shape[0], -1)),
                    compensated=self.compensated,
                )
                # Only worth it if the window actually skips tiles.
                if banded.band_tiles < banded.total_tiles:
                    self._banded = banded

        n = self.X.shape[0]
        if precond_rank == "auto":
            precond_rank = min(512, n // 4) if n >= 1024 else 0
        self.precond_rank = int(precond_rank)
        self._precond = None

        # -- anchor (evaluation) batch: block-elimination setup ---------
        self._anchors = None
        if anchor_X is not None:
            X1 = jnp.asarray(anchor_X).reshape((-1,) + prior.input_shape)
            Y1 = jnp.asarray(anchor_Y).reshape(-1)
            # W[i, j] = Cov(L u(X_i), u(X1_j)) = (L k)(X_i, X1_j).
            k_Lk = (
                apply_operator_to_kernel(L, k, argnum=0) if L is not None else k
            )
            from ..ops.linalg.chol import cholesky as robust_cholesky

            A11_g = gram_matrix(k, X1, X1)
            A11 = A11_g + anchor_noise * jnp.eye(X1.shape[0], dtype=A11_g.dtype)
            # Robust eager Cholesky (ops/linalg/chol.py): a float32
            # factorization can NaN near cond ~ 1/eps32 (a late pivot
            # rounds negative), and the escalating-jitter retry
            # recovers it.
            self._anchors = dict(
                X1=X1,
                Y1=Y1,
                k_Lk=k_Lk,
                chol1=robust_cholesky(A11, jitter=0.0),
                W=gram_matrix(k_Lk, self.X, X1),  # (n, n1)
            )

        self._weights = None
        self._anchor_weights = None
        self._solve_info = None
        self._host_matvec = None

    # -- checkpoint/resume (utils/serialization.save_posterior) ---------
    # The solved state (representer weights, anchor weights, Nyström
    # factors) and all geometry pickle; compiled programs and the banded
    # closure are process-local and rebuilt on load.
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_had_banded"] = self._banded is not None
        for k in ("_host_matvec", "_ff_programs", "_banded"):
            state[k] = None
        return state

    def __setstate__(self, state):
        had_banded = state.pop("_had_banded", False)
        self.__dict__.update(state)
        if had_banded and self._obs_spec is not None:
            x2d = np.asarray(self.X.reshape(self.X.shape[0], -1))
            self._banded = make_banded_matvec(
                self._obs_spec, x2d, x2d, compensated=self.compensated
            )

    # ------------------------------------------------------------------
    def _gram_matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        return self._gram_matvec_raw(v) + self.noise_variance * v

    def _preconditioner(self):
        """Lazily built Nyström preconditioner (None if rank 0)."""
        if self.precond_rank <= 0:
            return None
        if self._precond is None:
            idx = landmark_indices(self.X.shape[0], self.precond_rank)
            Z = self.X[idx]
            if self.precond_build in ("hybrid", "device"):
                build = (
                    nystrom_preconditioner_hybrid
                    if self.precond_build == "hybrid"
                    else nystrom_preconditioner_device
                )
                self._precond = build(
                    self._precond_block_fn, self.X, Z, self.noise_variance,
                )
            elif self._anchors is not None:
                # Anchored: build from the SCHUR-operator blocks (see
                # _precond_block_fn) so the preconditioner matches the
                # operator CG actually runs on.
                K_XZ = self._precond_block_fn(self.X, Z)
                K_ZZ = self._precond_block_fn(Z, Z)
                self._precond = nystrom_preconditioner(
                    K_XZ, K_ZZ, self.noise_variance
                )
            else:
                K_XZ = gram_matrix(self._k_obs, self.X, Z)
                K_ZZ = gram_matrix(self._k_obs, Z, Z)
                self._precond = nystrom_preconditioner(
                    K_XZ, K_ZZ, self.noise_variance
                )
        return self._precond

    def _schur_matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        """``S v`` with ``S = A22 − W A11^{-1} Wᵀ`` (just ``A22 v`` when
        no anchors): the CG operator of the block-eliminated system."""
        out = self._gram_matvec(v)
        if self._anchors is not None:
            a = self._anchors
            t = jax.scipy.linalg.cho_solve((a["chol1"], True), _mm(a["W"].T, v))
            out = out - _mm(a["W"], t)
        return out

    def _host_programs(self, M):
        """``(matvec, M_apply)`` callables for the host-CG loop, backed
        by jitted programs whose LARGE operands (anchor crosscov block,
        Nyström factor) are passed as ARGUMENTS — closure-captured
        arrays become constants embedded in the XLA program (see
        :func:`_apply_preconditioner`).

        The jitted matvec is memoized per instance: wrapping a fresh
        lambda in ``jax.jit`` on every ``_solve``/``var`` call would
        discard the trace cache and recompile."""
        if self._host_matvec is None:
            if self._anchors is not None:
                a = self._anchors
                base = jax.jit(
                    lambda W, chol1, v: self._gram_matvec(v)
                    - _mm(W, jax.scipy.linalg.cho_solve((chol1, True), _mm(W.T, v)))
                )
                self._host_matvec = lambda v: base(a["W"], a["chol1"], v)
            else:
                self._host_matvec = jax.jit(self._gram_matvec)
        M_apply = (lambda r: _apply_preconditioner(M, r)) if M is not None else None
        return self._host_matvec, M_apply

    def _precond_block_fn(self, x0, x1):
        """SCHUR-OPERATOR kernel block for the hybrid/device
        preconditioner build.  Two load-bearing details:

        - COMPENSATED evaluation when the kernel has term specs and
          compensation is on: at N=1e5 the plain-f32 coherent Gram error
          (~3.3e-7*n*k0) exceeds the floored damping delta, so an
          uncompensated build would re-impose the tail it is meant to
          resolve (the build costs n*m pairs once — negligible).
        - With ANCHORS, the CG operator is the Schur complement
          ``S = A22 - W A11^{-1} W^T``, and a preconditioner built from
          ``A22`` alone leaves ~n1 badly-mapped directions (1038 vs
          tens of iterations on a (200,100) grid with
          96 anchors).  ``S``'s blocks are themselves a PSD kernel (the
          anchor-posterior covariance), so the build just subtracts the
          same correction.
        """
        if self._obs_spec is not None and self.compensated:
            scale, terms = self._obs_spec
            out = terms_gram(
                terms,
                x0.reshape(x0.shape[0], -1),
                x1.reshape(x1.shape[0], -1),
                compensated=True,
            )
            out = scale * out if scale != 1.0 else out
        else:
            out = gram_matrix(self._k_obs, x0, x1)
        if self._anchors is not None:
            a = self._anchors
            U0 = gram_matrix(a["k_Lk"], x0, a["X1"])
            U1 = gram_matrix(a["k_Lk"], x1, a["X1"])
            out = out - _mm(
                U0, jax.scipy.linalg.cho_solve((a["chol1"], True), U1.T)
            )
        return out

    def _gram_matvec_raw(self, v: jnp.ndarray) -> jnp.ndarray:
        """Gram matvec WITHOUT the noise shift (pcg_ff applies sigma^2
        itself, in float-float)."""
        if self._kron_ff is not None:
            return self._kron_ff(v)
        if self._gram_linop is not None:
            return self._gram_linop @ v
        if self._banded is not None:
            return self._banded(v)
        x = self.X.reshape(self.X.shape[0], -1)
        if self._obs_spec is not None:
            return gram_matvec(self._obs_spec, x, x, v, compensated=self.compensated)
        return _mm(gram_matrix(self._k_obs, self.X), v)

    def _solve_device_cg(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Device-state float-float CG (``pcg_ff``): two fused programs
        and scalar-only host traffic per iteration.  The LARGE operands
        (Nyström factor, anchor crosscov block) ride as jit arguments;
        small closures (points, grid factor linops) are program
        constants."""
        M = self._preconditioner()

        def mv(aux, v):
            out = self._gram_matvec_raw(v)
            if aux is not None:
                W, chol1 = aux
                out = out - _mm(W, jax.scipy.linalg.cho_solve(
                    (chol1, True), _mm(W.T, v)
                ))
            return out

        precond = (
            (lambda aux, r: NystromPreconditioner(*aux)(r))
            if M is not None
            else None
        )
        if self._ff_programs is None:
            self._ff_programs = make_pcg_ff_programs(mv, precond)
        a = self._anchors
        res = pcg_ff(
            mv,
            precond,
            (a["W"], a["chol1"]) if a is not None else None,
            (M.B, M.chol_C, M.delta) if M is not None else None,
            rhs,
            self.noise_variance,
            tol=self.tol,
            maxiter=self.maxiter,
            programs=self._ff_programs,
        )
        self._solve_info = (int(res.iterations), float(res.relative_residual))
        return jnp.asarray(res.x, dtype=rhs.dtype)

    def _solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        if self.device_cg:
            return self._solve_device_cg(rhs)
        M = self._preconditioner()
        if self.host_cg:
            matvec_j, M_j = self._host_programs(M)
            res = pcg_host(
                matvec_j, np.asarray(rhs), M=M_j, tol=self.tol,
                maxiter=self.maxiter,
            )
            x = jnp.asarray(res.x, dtype=rhs.dtype)
        else:
            res = pcg(
                self._schur_matvec, rhs, M=M, tol=self.tol,
                maxiter=self.maxiter,
            )
            x = res.x
        self._solve_info = (int(res.iterations), float(res.relative_residual))
        return x

    @property
    def solve_info(self):
        """``(iterations, relative_residual)`` of the most recent solve."""
        return self._solve_info

    def refit(self, Y, anchor_Y=None) -> "IterativeGPRegressor":
        """Re-condition on NEW observation values, reusing every cached
        factor and compiled program (Nyström preconditioner, anchor
        Cholesky, banded schedule, ff CG step programs): the production
        repeated-solve path — same X/L/noise geometry, new data.  The
        preconditioner depends only on the geometry, so a refit costs
        one CG solve."""
        self.Y = jnp.asarray(Y).reshape(-1)
        if anchor_Y is not None:
            if self._anchors is None:
                raise ValueError("regressor was built without anchors")
            self._anchors["Y1"] = jnp.asarray(anchor_Y).reshape(-1)
        self._weights = None
        self._anchor_weights = None
        self._solve_info = None
        return self

    @property
    def representer_weights(self) -> jnp.ndarray:
        if self._weights is None:
            resid = self.Y - self._mean_obs(self.X).reshape(-1)
            if self._anchors is None:
                self._weights = self._solve(resid)
            else:
                a = self._anchors
                r1 = a["Y1"] - self.prior.mean(a["X1"]).reshape(-1)
                t1 = jax.scipy.linalg.cho_solve((a["chol1"], True), r1)
                self._weights = self._solve(resid - _mm(a["W"], t1))
                self._anchor_weights = jax.scipy.linalg.cho_solve(
                    (a["chol1"], True), r1 - _mm(a["W"].T, self._weights)
                )
        return self._weights

    # ------------------------------------------------------------------
    def mean(self, x) -> jnp.ndarray:
        x = jnp.asarray(x)
        batch = x.shape[: x.ndim - len(self.prior.input_shape)]
        xq = x.reshape((-1,) + self.prior.input_shape)
        w = self.representer_weights
        if self._cross_spec is not None:
            update = gram_matvec(
                self._cross_spec,
                xq.reshape(xq.shape[0], -1),
                self.X.reshape(self.X.shape[0], -1),
                w,
                compensated=self.compensated,
            )
        else:
            update = _mm(gram_matrix(self._k_cross, xq, self.X), w)
        if self._anchors is not None:
            a = self._anchors
            update = update + _mm(
                gram_matrix(self.prior.cov, xq, a["X1"]), self._anchor_weights
            )
        m = self.prior.mean(xq).reshape(-1)
        return (m + update).reshape(batch)

    def var(self, x, *, block_size: int = 256) -> jnp.ndarray:
        """Posterior variance by BLOCKED multi-RHS CG: each iteration is
        one shared ``(n, B)`` streaming Gram mat-mat, so a block of ``B``
        query columns costs ~one CG solve's worth of Gram traffic instead
        of ``B`` independent solves (O(N² · nq / B) total pair work).
        With anchors the update is the block quadratic form of the full
        2×2 system, evaluated through the same Schur elimination as the
        weights."""
        x = jnp.asarray(x)
        batch = x.shape[: x.ndim - len(self.prior.input_shape)]
        xq = x.reshape((-1,) + self.prior.input_shape)
        kxX = gram_matrix(self._k_cross, xq, self.X)  # (nq, n)
        anchors = self._anchors
        if anchors is not None:
            kx1 = gram_matrix(self.prior.cov, xq, anchors["X1"])  # (nq, n1)

        M = self._preconditioner()
        nq = kxX.shape[0]
        bs = min(block_size, nq)
        pad = (-nq) % bs
        rhs_all = jnp.concatenate(
            [kxX, jnp.zeros((pad, kxX.shape[1]), kxX.dtype)], axis=0
        )

        if self.device_cg:
            return self._var_device(
                xq, batch, rhs_all, kx1 if anchors is not None else None,
                M, bs, nq,
            )
        if self.host_cg:
            return self._var_host(
                xq, batch, rhs_all, kx1 if anchors is not None else None,
                M, bs, nq,
            )

        def schur_block(rhs_block):  # (bs, n) -> update (bs,)
            U2 = rhs_block.T  # (n, bs)
            S2 = pcg_block(
                self._schur_matvec, U2, M=M, tol=self.tol,
                maxiter=self.maxiter,
            ).x
            return jnp.sum(U2 * S2, axis=0)

        if anchors is None:
            updates = jax.lax.map(
                schur_block, rhs_all.reshape(-1, bs, kxX.shape[1])
            ).reshape(-1)[:nq]
        else:
            a = anchors
            kx1_all = jnp.concatenate(
                [kx1, jnp.zeros((pad, kx1.shape[1]), kx1.dtype)], axis=0
            )

            def anchored_block(args):
                rhs_block, kx1_block = args
                U2 = rhs_block.T  # (n, bs)
                U1 = kx1_block.T  # (n1, bs)
                T1 = jax.scipy.linalg.cho_solve((a["chol1"], True), U1)
                R2 = U2 - _mm(a["W"], T1)
                S2 = pcg_block(
                    self._schur_matvec, R2, M=M, tol=self.tol,
                    maxiter=self.maxiter,
                ).x
                Z1 = T1 - jax.scipy.linalg.cho_solve(
                    (a["chol1"], True), _mm(a["W"].T, S2)
                )
                return jnp.sum(U2 * S2, axis=0) + jnp.sum(U1 * Z1, axis=0)

            updates = jax.lax.map(
                anchored_block,
                (
                    rhs_all.reshape(-1, bs, kxX.shape[1]),
                    kx1_all.reshape(-1, bs, kx1.shape[1]),
                ),
            ).reshape(-1)[:nq]
        prior_var = self.prior.cov(xq)
        return jnp.maximum(prior_var - updates, 0.0).reshape(batch)

    def _var_device(self, xq, batch, rhs_all, kx1, M, bs, nq) -> jnp.ndarray:
        """Posterior variance by device-state blocked ff CG
        (``pcg_block_ff``): one shared (n, bs) streaming mat-mat per
        iteration, CG state on device, per-column residual scalars the
        only per-iteration host traffic (``_var_host`` moves O(n*bs)
        buffers between host and device every iteration)."""
        anchors = self._anchors

        def mv(aux, v):
            out = self._gram_matvec_raw(v)
            if aux is not None:
                W, chol1 = aux
                out = out - _mm(W, jax.scipy.linalg.cho_solve(
                    (chol1, True), _mm(W.T, v)
                ))
            return out

        precond = (
            (lambda aux, r: NystromPreconditioner(*aux)(r))
            if M is not None
            else None
        )
        programs = make_pcg_block_ff_programs(mv, precond)
        mv_aux = (anchors["W"], anchors["chol1"]) if anchors is not None else None
        pc_aux = (M.B, M.chol_C, M.delta) if M is not None else None

        if anchors is not None:
            kx1 = jnp.concatenate(
                [
                    kx1,
                    jnp.zeros((rhs_all.shape[0] - nq, kx1.shape[1]), kx1.dtype),
                ]
            )
        updates = []
        nblocks = rhs_all.shape[0] // bs
        for i in range(nblocks):
            U2 = rhs_all[i * bs:(i + 1) * bs].T  # (n, bs) on device
            if anchors is None:
                res = pcg_block_ff(
                    mv, precond, mv_aux, pc_aux, U2, self.noise_variance,
                    tol=self.tol, maxiter=self.maxiter, programs=programs,
                )
                updates.append(jnp.sum(U2 * res.x, axis=0))
            else:
                a = anchors
                U1 = kx1[i * bs:(i + 1) * bs].T  # (n1, bs)
                T1 = jax.scipy.linalg.cho_solve((a["chol1"], True), U1)
                R2 = U2 - _mm(a["W"], T1)
                res = pcg_block_ff(
                    mv, precond, mv_aux, pc_aux, R2, self.noise_variance,
                    tol=self.tol, maxiter=self.maxiter, programs=programs,
                )
                S2 = res.x
                Z1 = T1 - jax.scipy.linalg.cho_solve(
                    (a["chol1"], True), _mm(a["W"].T, S2)
                )
                updates.append(
                    jnp.sum(U2 * S2, axis=0) + jnp.sum(U1 * Z1, axis=0)
                )
        updates = jnp.concatenate(updates)[:nq]
        prior_var = self.prior.cov(xq)
        return jnp.maximum(prior_var - updates, 0.0).reshape(batch)

    def _var_host(self, xq, batch, rhs_all, kx1, M, bs, nq) -> jnp.ndarray:
        """Host-orchestrated variance sweep: pcg_block_host per query
        block — same Schur elimination as the device path, but the CG
        loop drives separately jitted matvec / preconditioner-apply
        programs with host float64 vectors."""
        import scipy.linalg

        matvec_j, M_j = self._host_programs(M)
        rhs_np = np.asarray(rhs_all, np.float64)
        anchors = self._anchors
        if anchors is not None:
            chol1 = np.asarray(anchors["chol1"], np.float64)
            W = np.asarray(anchors["W"], np.float64)
            kx1_np = np.concatenate(
                [
                    np.asarray(kx1, np.float64),
                    np.zeros((rhs_np.shape[0] - nq, kx1.shape[1])),
                ]
            )
        updates = []
        for i in range(rhs_np.shape[0] // bs):
            U2 = rhs_np[i * bs:(i + 1) * bs].T  # (n, bs)
            if anchors is None:
                S2 = pcg_block_host(
                    matvec_j, U2, M=M_j, tol=self.tol, maxiter=self.maxiter
                ).x
                updates.append(np.sum(U2 * S2, axis=0))
            else:
                U1 = kx1_np[i * bs:(i + 1) * bs].T  # (n1, bs)
                T1 = scipy.linalg.cho_solve((chol1, True), U1)
                R2 = U2 - W @ T1
                S2 = pcg_block_host(
                    matvec_j, R2, M=M_j, tol=self.tol, maxiter=self.maxiter
                ).x
                Z1 = T1 - scipy.linalg.cho_solve((chol1, True), W.T @ S2)
                updates.append(np.sum(U2 * S2, axis=0) + np.sum(U1 * Z1, axis=0))
        updates = np.concatenate(updates)[:nq]
        prior_var = np.asarray(self.prior.cov(xq), np.float64)
        out = np.maximum(prior_var - updates, 0.0).reshape(batch)
        from ..config import config as _config

        return jnp.asarray(out, _config.default_dtype)

    def std(self, x, **kw) -> jnp.ndarray:
        return jnp.sqrt(self.var(x, **kw))
