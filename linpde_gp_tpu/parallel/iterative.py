"""Distributed gram-free conditioning: the north-star N=1e5 path on a mesh.

The single-device gram-free engine (``models/iterative.py``) streams the
operator-transformed Gram through the lazy kernel reduction each CG
iteration — O(N²) pair compute, O(N) memory.  This module shards that
matvec over ALL devices of a ``jax.sharding.Mesh``: each device owns a
contiguous row block of the collocation points and produces its slice of
``K v`` with the SAME fused reduction (``ops/gram.xla_gram_matvec``),
so per-device pair work is O(N²/P) and per-iteration communication is
two O(N) all-gathers (the matvec output and the preconditioner
correction).  The Nyström preconditioner is built from row-sharded
``(n/P, m)`` blocks reduced by one ``psum`` — the factor ``B`` is never
replicated.

This is the mesh generalization of the reference's KeOps lazy reduction
(consumed at ``covfuncs/_tensor_product.py:111-130``), which is
single-process; the reference has no multi-device story at all
(SURVEY.md §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import backend
from ..config import config
from ..ops.linalg.pcg import landmark_indices
from ..ops.gram import (
    _round_up,
    band_starts,
    band_windows,
    banded_panel_matvec,
    compact_support_radius,
    kernel_term_specs,
    xla_gram_matvec,
    terms_gram,
)
from ..ops.transforms.dispatch import apply_operator_to_kernel
from ..models.functions.base import Zero


def _axes(mesh: Mesh):
    return tuple(mesh.axis_names)


def _pad_rows(X, P_total):
    n = X.shape[0]
    n_pad = ((n + P_total - 1) // P_total) * P_total
    if n_pad != n:
        X = np.concatenate([X, np.broadcast_to(X[-1:], (n_pad - n,) + X.shape[1:])])
    return X, n_pad


def distributed_gram_matvec(spec, X0, X1, v, *, mesh: Mesh, compensated=None,
                            gather: bool = False):
    """``scale * K(X0, X1) @ v`` with the row axis sharded over every
    mesh device: each device streams its (n0/P, n1) pair block through
    the local reduction.

    The result stays ROW-SHARDED over the mesh (``out_specs=P(axes)``) —
    O(n0/P) memory per device, the right shape for large query counts.
    Pass ``gather=True`` to all-gather a replicated result on every
    device (one tiled O(n0) collective).
    """
    scale, terms = spec
    if compensated is None:
        compensated = config.gram_compensated
    X0 = np.asarray(X0)
    if X0.ndim == 1:
        X0 = X0[:, None]
    P_total = mesh.devices.size
    n0 = X0.shape[0]
    X0p, n_pad = _pad_rows(X0, P_total)
    axes = _axes(mesh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axes, None), P(None, None), P(None)),
        out_specs=P(None) if gather else P(axes),
    )
    def matvec(x0_loc, x1, vv):
        out_loc = xla_gram_matvec(terms, x0_loc, x1, vv, compensated=compensated)
        if gather:
            return jax.lax.all_gather(out_loc, axes, axis=0, tiled=True)
        return out_loc

    X1 = jnp.asarray(X1)
    if X1.ndim == 1:
        X1 = X1[:, None]
    out = matvec(jnp.asarray(X0p), X1, jnp.asarray(v))
    out = out[:n0]
    return scale * out if scale != 1.0 else out


class DistributedIterativeGPRegressor:
    """Gram-free GP conditioning with every O(N²) stage sharded over a
    device mesh — mirrors :class:`models.iterative.IterativeGPRegressor`
    (same constructor semantics plus ``mesh=``), equivalence tested to CG
    tolerance on the 8-device CPU mesh (``tests/test_parallel.py``).

    Per PCG iteration on P devices:

    - local streaming matvec: O(N²/P) pair evaluations;
    - 2 tiled all-gathers of O(N) vectors + 1 psum of an (m,) vector;
    - replicated O(N) vector algebra (negligible).

    The Nyström preconditioner's ``(N, m)`` factor stays row-sharded for
    its whole life; only the (m, m) normal matrix is psum-reduced.
    """

    def __init__(
        self,
        prior,
        X,
        Y,
        *,
        mesh: Mesh,
        L=None,
        noise_variance: float = 1e-6,
        tol: float = 1e-6,
        maxiter: int = 512,
        precond_rank: int | str = "auto",
        compensated: bool | None = None,
    ):
        if prior.output_shape != ():
            raise ValueError("DistributedIterativeGPRegressor supports scalar outputs.")
        self.prior = prior
        self.mesh = mesh
        self.X = np.asarray(X).reshape((-1,) + prior.input_shape)
        self.Y = np.asarray(Y).reshape(-1)
        self.noise_variance = float(noise_variance)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.compensated = (
            config.gram_compensated if compensated is None else bool(compensated)
        )

        k = prior.cov
        if L is not None:
            k_obs = apply_operator_to_kernel(
                L, apply_operator_to_kernel(L, k, argnum=1), argnum=0
            )
            k_cross = apply_operator_to_kernel(L, k, argnum=1)
            mean_obs = L(prior.mean) if not isinstance(prior.mean, Zero) else prior.mean
        else:
            k_obs, k_cross, mean_obs = k, k, prior.mean
        self._k_obs, self._k_cross, self._mean_obs = k_obs, k_cross, mean_obs
        self._obs_spec = kernel_term_specs(k_obs)
        self._cross_spec = kernel_term_specs(k_cross)
        if self._obs_spec is None or self._cross_spec is None:
            raise ValueError(
                "gram-free distributed conditioning requires the closed-form "
                "sum-of-products kernel family (use the dense "
                "DistributedConditioner otherwise)"
            )

        n = self.X.shape[0]
        if precond_rank == "auto":
            precond_rank = min(512, n // 4) if n >= 1024 else 0
        self.precond_rank = int(min(precond_rank, n))

        self._weights = None
        self._solve_info = None
        self._nys = None

        # Compact-support (Wendland) banded routing: the observation
        # points are SORTED internally along input dim 0, so each
        # device's contiguous row slab only touches the O(band) column
        # tiles within the support radius.  Public surfaces
        # (representer_weights, mean, var) keep the caller's original
        # point order.
        self._order = None
        _scale_o, _terms_o = self._obs_spec
        if backend.route(
            "matvec", n0=n, n1=n, compact=compact_support_radius(_terms_o, 0) is not None
        ) == "banded":
            order = np.argsort(
                self.X.reshape(self.X.shape[0], -1)[:, 0], kind="stable"
            )
            self._order = order
            self._inv_order = np.argsort(order)

    # -- padded geometry ------------------------------------------------
    def _geometry(self):
        """Padded 2-D point array (internally SORTED when banded)."""
        P_total = self.mesh.devices.size
        n = self.X.shape[0]
        x2d = self.X.reshape(n, -1)
        if self._order is not None:
            x2d = x2d[self._order]
        x_pad, n_pad = _pad_rows(x2d, P_total)
        return x_pad, n, n_pad, n_pad // P_total

    def _band_info(self):
        """Static banded-matvec schedule per device, or ``None``.

        Returns ``(tile0, tile1, band, js, n0p_loc, n1p)`` with ``js``
        an (P, ntiles0_loc) int32 array of per-device column-tile window
        offsets.  The band width is the MAX over devices so every device
        runs the same program.
        """
        scale, terms = self._obs_spec
        radius = compact_support_radius(terms, 0)
        if radius is None or self._order is None:
            return None
        x_pad, n, n_pad, n_loc = self._geometry()
        P_total = self.mesh.devices.size
        tile0 = min(config.band_tile, n_loc)
        tile1 = min(config.band_tile, n_pad)
        n0p_loc = _round_up(n_loc, tile0)
        n1p = _round_up(n_pad, tile1)
        ntiles1 = n1p // tile1
        c1 = x_pad[:, 0]  # globally sorted (pad rows repeat the max)
        lo_list, hi_list = [], []
        for dev in range(P_total):
            slab = x_pad[dev * n_loc : (dev + 1) * n_loc]
            n_real = max(0, min(n - dev * n_loc, n_loc))
            j_lo, j_hi = band_windows(
                slab, n_real, c1, radius, tile0, tile1, n0p_loc
            )
            lo_list.append(j_lo)
            hi_list.append(j_hi)
        band, _ = band_starts(
            np.concatenate(lo_list), np.concatenate(hi_list), ntiles1
        )
        if band >= ntiles1:
            return None  # window covers everything: dense path is simpler
        js = np.stack(
            [
                np.clip(np.minimum(l, ntiles1 - band), 0, None).astype(np.int32)
                for l in lo_list
            ]
        )
        return tile0, tile1, band, js, n0p_loc, n1p

    # -- Nyström factor (built ONCE, row-sharded, shared by condition
    #    and variance programs) ----------------------------------------
    def _nystrom(self):
        """``(B, chol_C, delta)``: the tail-damped Nyström preconditioner
        factors of the UNSCALED noisy Gram, with ``B`` (n_pad, m) kept
        row-sharded over the mesh for its whole life (only the (m, m)
        normal matrix is psum-reduced).  ``precond_rank == 0`` degrades
        to exact identity factors (zero ``B``, unit ``delta``)."""
        if self._nys is not None:
            return self._nys
        scale, terms = self._obs_spec
        mesh, axes = self.mesh, _axes(self.mesh)
        x_pad, n, n_pad, n_loc = self._geometry()
        m = self.precond_rank
        dtype = jnp.asarray(self.Y).dtype
        if not jnp.issubdtype(dtype, jnp.floating):
            dtype = config.default_dtype
        sigma_sq = self.noise_variance / scale

        if m == 0:
            self._nys = (
                jnp.zeros((n_pad, 1), dtype),
                jnp.eye(1, dtype=dtype),
                jnp.ones((1,), dtype),
            )
            return self._nys

        idx = np.asarray(landmark_indices(n, m))
        z = jnp.asarray(x_pad[idx], dtype)

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axes, None), P(None, None)),
            out_specs=(P(axes, None), P(None, None), P(None)),
        )
        def build(x_loc, zz):
            dev = jax.lax.axis_index(axes)
            row_ids = (
                jax.lax.broadcasted_iota(jnp.int32, (n_loc, 1), 0)[:, 0]
                + dev * n_loc
            )
            mask_loc = (row_ids < n).astype(dtype)
            hi = jax.lax.Precision.HIGHEST
            K_zz = terms_gram(terms, zz, zz)
            eps = jnp.finfo(dtype).eps
            # Floored stabilizer (mirrors
            # ops/linalg/pcg.nystrom_preconditioner_device): the legacy
            # eps*trace*m ridge is ~m/8 times larger and truncates the
            # preconditioner's resolved spectrum (326 vs 53 iterations
            # at N=1e5 on the single-device path).  lambda_1 by in-trace
            # power iteration; the f32 Cholesky at cond ~ 1/(8 eps32)
            # can round a late pivot negative, so a x100-jitter fallback
            # factor is selected when the first one NaNs (no eager retry
            # inside shard_map).
            v0 = jnp.ones((m,), dtype) / jnp.sqrt(jnp.asarray(m, dtype))

            def _pow(_, v):
                w = jnp.matmul(K_zz, v, precision=hi)
                return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

            lam1 = jnp.linalg.norm(
                jnp.matmul(K_zz, jax.lax.fori_loop(0, 16, _pow, v0),
                           precision=hi)
            )
            stab = 8.0 * eps * lam1
            eye_m = jnp.eye(m, dtype=dtype)
            L1 = jnp.linalg.cholesky(K_zz + stab * eye_m)
            L2 = jnp.linalg.cholesky(K_zz + (100.0 * stab) * eye_m)
            L_zz = jnp.where(jnp.any(jnp.isnan(L1)), L2, L1)
            K_xz_loc = terms_gram(terms, x_loc, zz) * mask_loc[:, None]
            B_loc = jax.lax.linalg.triangular_solve(
                L_zz, K_xz_loc, left_side=False, lower=True, transpose_a=True
            )
            C0 = jax.lax.psum(jnp.matmul(B_loc.T, B_loc, precision=hi), axes)
            C0 = 0.5 * (C0 + C0.T)
            lam = jnp.linalg.eigvalsh(C0)
            # Delta floor at 8*eps*lambda_1(C0) — the f32 Woodbury apply's
            # cancellation limit (see nystrom_preconditioner_device).
            lam_m = jnp.clip(lam[0], 8.0 * eps * jnp.maximum(lam[-1], 0.0), None)
            delta = lam_m + sigma_sq
            C1 = jnp.linalg.cholesky(C0 + delta * jnp.eye(m, dtype=dtype))
            bad = jnp.any(jnp.isnan(C1))
            delta = jnp.where(bad, 10.0 * delta, delta)
            C2 = jnp.linalg.cholesky(C0 + delta * jnp.eye(m, dtype=dtype))
            chol_C = jnp.where(bad, C2, C1)
            return B_loc, chol_C, delta[None].astype(dtype)

        self._nys = build(jnp.asarray(x_pad, dtype), z)
        return self._nys

    # -- local (per-device) streaming matvec: dense or banded -----------
    def _local_matvec_builder(self):
        """Returns ``mv(x_loc, x_full, V) -> (n_loc, r)`` — the
        per-device slice of the streamed Gram product, banded when the
        kernel is compactly supported (``_band_info``)."""
        scale, terms = self._obs_spec
        compensated = self.compensated
        binfo = self._band_info()
        if binfo is None:
            def mv(dev, x_loc, x_full, V):
                return xla_gram_matvec(
                    terms, x_loc, x_full, V, compensated=compensated
                )

            return mv

        tile0, tile1, band, js, n0p_loc, n1p = binfo
        x_pad, n, n_pad, n_loc = self._geometry()
        d = x_pad.shape[1]
        js_all = jnp.asarray(js)  # (P, ntiles0_loc), replicated

        def mv(dev, x_loc, x_full, V):
            dtype = V.dtype
            V2 = V if V.ndim > 1 else V[:, None]
            X0p = jnp.zeros((n0p_loc, d), dtype).at[:n_loc].set(x_loc.astype(dtype))
            X1p = jnp.zeros((n1p, d), dtype).at[: x_full.shape[0]].set(
                x_full.astype(dtype)
            )
            vp = jnp.zeros((n1p, V2.shape[1]), dtype).at[: V2.shape[0]].set(V2)
            js_loc = jax.lax.dynamic_index_in_dim(
                js_all, dev, axis=0, keepdims=False
            )
            out = banded_panel_matvec(
                terms, X0p, js_loc, X1p, vp, tile0=tile0, tile1=tile1,
                band=band, compensated=bool(compensated),
            )[:n_loc]
            return out[:, 0] if V.ndim == 1 else out

        return mv

    # ------------------------------------------------------------------
    def _condition_fn(self):
        """shard_map'd mesh PCG against the prebuilt Nyström factors."""
        scale, terms = self._obs_spec
        mesh, axes = self.mesh, _axes(self.mesh)
        x_pad, n, n_pad, n_loc = self._geometry()
        tol, maxiter = self.tol, self.maxiter
        compensated = self.compensated
        local_mv = self._local_matvec_builder()
        sigma_sq = self.noise_variance / scale  # work on the unscaled Gram

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P(axes, None), P(None, None),
                P(axes, None), P(None, None), P(None), P(None),
            ),
            out_specs=(P(None), P(None), P(None)),
            # The CG vectors are replicated by construction (each device
            # builds them from all-gathered slices), which the
            # varying-axes check cannot see through the while_loop carry.
            check_vma=False,
        )
        def condition(x_loc, x_full, B_loc, chol_C, delta, b):
            dev = jax.lax.axis_index(axes)
            dtype = b.dtype
            row_ids = (
                jax.lax.broadcasted_iota(jnp.int32, (n_loc, 1), 0)[:, 0]
                + dev * n_loc
            )
            mask_loc = (row_ids < n).astype(dtype)
            mask_full = (
                jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)[:, 0] < n
            ).astype(dtype)
            hi = jax.lax.Precision.HIGHEST

            def matvec(v_full):
                # A v = mask ∘ K ∘ mask v + sigma^2 v  (pad rows are a
                # decoupled sigma^2 I block, so zero-padded RHS stays
                # exactly supported on the real rows).
                out_loc = local_mv(dev, x_loc, x_full, v_full * mask_full)
                out = jax.lax.all_gather(
                    out_loc * mask_loc, axes, axis=0, tiled=True
                )
                return out + sigma_sq * v_full

            def precond(r_full):
                r_loc = jax.lax.dynamic_slice_in_dim(
                    r_full, dev * n_loc, n_loc
                )
                br = jax.lax.psum(
                    jnp.matmul(B_loc.T, r_loc[:, None], precision=hi), axes
                )
                w = jax.scipy.linalg.cho_solve((chol_C, True), br)
                bw_loc = jnp.matmul(B_loc, w, precision=hi)[:, 0]
                bw = jax.lax.all_gather(bw_loc, axes, axis=0, tiled=True)
                return (r_full - bw) / delta[0]

            # --- PCG (replicated vectors, deterministic across devices) -
            r = b
            z0 = precond(r)
            p = z0
            rz = jnp.vdot(r, z0)
            b_norm = jnp.linalg.norm(b)
            threshold = tol * jnp.where(b_norm > 0, b_norm, 1.0)
            x0 = jnp.zeros_like(b)

            def cond_fn(state):
                _, r, _, _, k = state
                return jnp.logical_and(
                    jnp.linalg.norm(r) > threshold, k < maxiter
                )

            def body(state):
                x, r, p, rz, k = state
                Ap = matvec(p)
                alpha = rz / jnp.vdot(p, Ap)
                x = x + alpha * p
                r_new = r - alpha * Ap
                zv = precond(r_new)
                rz_new = jnp.vdot(r_new, zv)
                # Polak–Ribière (flexible CG under the inexact streaming
                # matvec — same rationale as ops/linalg/pcg.py).
                beta = jnp.maximum((rz_new - jnp.vdot(zv, r)) / rz, 0.0)
                p = zv + beta * p
                return x, r_new, p, rz_new, k + 1

            x, r, _, _, k = jax.lax.while_loop(
                cond_fn, body, (x0, r, p, rz, jnp.array(0))
            )
            relres = jnp.linalg.norm(r) / jnp.where(b_norm > 0, b_norm, 1.0)
            return x, k[None], relres[None]

        return condition, x_pad, n_pad

    @property
    def representer_weights(self) -> jnp.ndarray:
        if self._weights is None:
            n = self.X.shape[0]
            scale, _terms = self._obs_spec
            resid = np.asarray(
                self.Y - np.asarray(self._mean_obs(self.X)).reshape(-1)
            )
            if self._order is not None:  # banded: internal sorted order
                resid = resid[self._order]
            condition, x_pad, n_pad = self._condition_fn()
            b = jnp.zeros(n_pad, jnp.asarray(resid).dtype).at[:n].set(resid)
            Bn, chol_C, delta = self._nystrom()
            # The shard-mapped solve works on the UNSCALED Gram (scale
            # folded into the rhs) so term specs stay pure.
            w, iters, relres = condition(
                jnp.asarray(x_pad), jnp.asarray(x_pad),
                Bn, chol_C, delta, b / scale,
            )
            w = w[:n]
            if self._order is not None:
                w = jnp.take(w, jnp.asarray(self._inv_order), axis=0)
            self._weights = w
            self._solve_info = (int(iters[0]), float(relres[0]))
        return self._weights

    @property
    def solve_info(self):
        return self._solve_info

    # ------------------------------------------------------------------
    def mean(self, x) -> jnp.ndarray:
        """Posterior mean with the QUERY axis sharded over the mesh
        (the result stays row-sharded; ``np.asarray`` gathers it)."""
        x = jnp.asarray(x)
        batch = x.shape[: x.ndim - len(self.prior.input_shape)]
        xq = np.asarray(x).reshape((-1,) + self.prior.input_shape)
        w = self.representer_weights
        update = distributed_gram_matvec(
            self._cross_spec,
            xq.reshape(xq.shape[0], -1),
            self.X.reshape(self.X.shape[0], -1),
            w,
            mesh=self.mesh,
            compensated=self.compensated,
        )
        mprior = self.prior.mean(jnp.asarray(xq)).reshape(-1)
        return (mprior + update).reshape(batch)

    # ------------------------------------------------------------------
    def _var_fn(self, bq: int):
        """shard_map'd blocked multi-RHS PCG for the posterior variance
        (the mesh port of ``models/iterative.py::var`` / ``pcg_block``;
        reference analog: the batched variance path of
        ``_conditional.py:223-251``).

        Per query block of ``bq`` points: every device assembles its
        (n/P, bq) slice of the cross Gram ``k_cross(X, x_q)``, the block
        CG shares ONE sharded streaming mat-mat per iteration across all ``bq`` right-hand sides (per-column
        step sizes, converged columns frozen), and the variance update
        is the diagonal of ``Uᵀ A⁻¹ U``.
        """
        scale_o, terms_o = self._obs_spec
        scale_c, terms_c = self._cross_spec
        mesh, axes = self.mesh, _axes(self.mesh)
        x_pad, n, n_pad, n_loc = self._geometry()
        tol, maxiter = self.tol, self.maxiter
        compensated = self.compensated
        local_mv = self._local_matvec_builder()
        sigma_sq = self.noise_variance / scale_o
        # u^T (scale_o K + s^2)^{-1} u with u = scale_c * u_unscaled:
        coef = scale_c * scale_c / scale_o

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                P(axes, None), P(None, None),
                P(axes, None), P(None, None), P(None), P(None, None),
            ),
            out_specs=(P(None), P(None), P(None)),
            check_vma=False,  # replicated CG state, as in _condition_fn
        )
        def var_block(x_loc, x_full, B_loc, chol_C, delta, xq_b):
            dev = jax.lax.axis_index(axes)
            dtype = xq_b.dtype
            row_ids = (
                jax.lax.broadcasted_iota(jnp.int32, (n_loc, 1), 0)[:, 0]
                + dev * n_loc
            )
            mask_loc = (row_ids < n).astype(dtype)
            mask_full = (
                jax.lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)[:, 0] < n
            ).astype(dtype)
            hi = jax.lax.Precision.HIGHEST

            # Row-sharded cross-Gram block: rows are observation points,
            # columns the bq query points.  terms_c define
            # k_cross(query, obs), so evaluate (bq, n_loc) and transpose.
            u_loc = terms_gram(terms_c, xq_b, x_loc).T * mask_loc[:, None]
            U = jax.lax.all_gather(u_loc, axes, axis=0, tiled=True)

            def matmat(V):
                out_loc = local_mv(dev, x_loc, x_full, V * mask_full[:, None])
                out = jax.lax.all_gather(
                    out_loc * mask_loc[:, None], axes, axis=0, tiled=True
                )
                return out + sigma_sq * V

            def precond(R):
                r_loc = jax.lax.dynamic_slice_in_dim(R, dev * n_loc, n_loc)
                br = jax.lax.psum(
                    jnp.matmul(B_loc.T, r_loc, precision=hi), axes
                )
                w = jax.scipy.linalg.cho_solve((chol_C, True), br)
                bw_loc = jnp.matmul(B_loc, w, precision=hi)
                bw = jax.lax.all_gather(bw_loc, axes, axis=0, tiled=True)
                return (R - bw) / delta[0]

            # --- block PCG (ops/linalg/pcg.py::pcg_block, mesh matvec) -
            Xs = jnp.zeros_like(U)
            R = U
            Z = precond(R)
            Pm = Z
            rz = jnp.sum(R * Z, axis=0)
            b_norm = jnp.linalg.norm(U, axis=0)
            threshold = tol * jnp.where(b_norm > 0, b_norm, 1.0)

            def cond_fn(state):
                _, R, _, _, k = state
                return jnp.logical_and(
                    jnp.any(jnp.linalg.norm(R, axis=0) > threshold),
                    k < maxiter,
                )

            def body(state):
                Xs, R, Pm, rz, k = state
                active = jnp.linalg.norm(R, axis=0) > threshold
                AP = matmat(Pm)
                pAp = jnp.sum(Pm * AP, axis=0)
                alpha = jnp.where(
                    active, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0
                )
                Xs = Xs + alpha[None, :] * Pm
                R_new = R - alpha[None, :] * AP
                Z = precond(R_new)
                rz_new = jnp.sum(R_new * Z, axis=0)
                pr = rz_new - jnp.sum(Z * R, axis=0)
                beta = jnp.where(
                    active,
                    jnp.maximum(pr / jnp.where(rz != 0, rz, 1.0), 0.0),
                    0.0,
                )
                Pm = Z + beta[None, :] * Pm
                return Xs, R_new, Pm, jnp.where(active, rz_new, rz), k + 1

            Xs, R, _, _, k = jax.lax.while_loop(
                cond_fn, body, (Xs, R, Pm, rz, jnp.array(0))
            )
            relres = jnp.max(
                jnp.linalg.norm(R, axis=0)
                / jnp.where(b_norm > 0, b_norm, 1.0)
            )
            update = coef * jnp.sum(U * Xs, axis=0)
            return update, k[None], relres[None]

        return var_block, x_pad

    def var(self, x, *, block_size: int = 256) -> jnp.ndarray:
        """Posterior pointwise variance, query axis processed in blocks;
        every O(N² · nq / block) unit of pair work is sharded over the
        mesh (one multi-RHS mesh PCG per block)."""
        x = jnp.asarray(x)
        batch = x.shape[: x.ndim - len(self.prior.input_shape)]
        xq = np.asarray(x).reshape((-1,) + self.prior.input_shape)
        xq2d = xq.reshape(xq.shape[0], -1)
        nq = xq2d.shape[0]
        bq = min(int(block_size), nq)
        var_block, x_pad = self._var_fn(bq)
        Bn, chol_C, delta = self._nystrom()
        dtype = Bn.dtype
        x_dev = jnp.asarray(x_pad, dtype)

        updates = []
        info = (0, 0.0)
        for start in range(0, nq, bq):
            blk = xq2d[start : start + bq]
            pad = bq - blk.shape[0]
            if pad:  # repeat the last point; padded columns are dropped
                blk = np.concatenate([blk, np.broadcast_to(blk[-1:], (pad, blk.shape[1]))])
            upd, iters, relres = var_block(
                x_dev, x_dev, Bn, chol_C, delta, jnp.asarray(blk, dtype)
            )
            updates.append(upd[: bq - pad] if pad else upd)
            info = (max(info[0], int(iters[0])), max(info[1], float(relres[0])))
        self._solve_info = info
        update = jnp.concatenate(updates)
        prior_var = self.prior.cov(jnp.asarray(xq)).reshape(-1)
        return jnp.maximum(prior_var - update, 0.0).reshape(batch)

    def std(self, x, **kw) -> jnp.ndarray:
        return jnp.sqrt(self.var(x, **kw))
