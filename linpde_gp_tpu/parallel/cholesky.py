"""Distributed blocked Cholesky factorization and triangular solves.

Generalizes the reference's 2x2 symbolic Schur machinery
(``linops/_block.py:226-268``) from two blocks to P x (n/nb) device
tiles, per SURVEY.md §2 "parallelism" checklist:

- The Gram is CONTIGUOUSLY ROW-SHARDED over all mesh devices (each holds
  ``(n/P, n)``).
- Right-looking blocked factorization: per block-column ``k`` the panel
  is all-gathered (``jax.lax.all_gather``), every device
  redundantly factorizes the ``nb x nb`` diagonal block (cheap, avoids a
  broadcast round-trip), computes its rows of the panel, and applies the
  trailing GEMM update to its local rows only.  Communication per step is
  ``n * nb`` — total ``n^2`` over the factorization.
- Triangular solves use the same layout with ``psum``-broadcast of each
  solved block.

All shapes are static (full-width masked updates instead of shrinking
trailing slices — a factor <=2 of extra FLOPs in exchange for a single
compiled XLA program with no dynamic shapes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import config


def _flat_axes(mesh: Mesh):
    return tuple(mesh.axis_names)


def distributed_cholesky(
    gram: jnp.ndarray,
    *,
    mesh: Mesh,
    block_size: int = 512,
    jitter: float | None = None,
    unroll: bool | None = None,
) -> jnp.ndarray:
    """Lower Cholesky factor of an SPD matrix, row-sharded over ``mesh``.

    ``gram``: ``(n, n)`` with ``n`` divisible by ``P * block_size`` where
    ``P`` is the total device count (pad upstream if needed).

    ``unroll=True`` (default for <= 128 block-columns) unrolls the
    block loop with STATIC panel offsets: trailing updates become
    exact-width GEMMs instead of masked full-width ones — half the FLOPs
    at the cost of a longer compile.
    """
    n = gram.shape[0]
    num_devices = mesh.devices.size
    nb = block_size
    assert n % (num_devices * nb) == 0, (
        f"n={n} must be divisible by P*nb={num_devices * nb}"
    )
    nblocks = n // nb
    rows_per_dev = n // num_devices
    if jitter is None:
        jitter = config.cholesky_jitter
    if unroll is None:
        unroll = nblocks <= 128
    axes = _flat_axes(mesh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axes, None),
        out_specs=P(axes, None),
    )
    def factorize(a_loc):
        # Device coordinates -> linear index over all mesh axes.
        dev = jax.lax.axis_index(axes)
        my_first_row = dev * rows_per_dev
        local_rows = jax.lax.broadcasted_iota(
            jnp.int32, (rows_per_dev, 1), 0
        )[:, 0] + my_first_row  # global row ids of local rows
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)[0]

        if jitter:
            local_diag = a_loc[jnp.arange(rows_per_dev), local_rows]
            diag_scale = jax.lax.pmean(jnp.mean(local_diag), axes)
            eye_loc = (col_ids[None, :] == local_rows[:, None]).astype(a_loc.dtype)
            a_loc = a_loc + (jitter * diag_scale) * eye_loc

        def step(k, a_loc):
            kb = (k * nb).astype(jnp.int32) if hasattr(k, 'astype') else jnp.int32(k * nb)
            # Local slice of the panel (column block k).
            c_loc = jax.lax.dynamic_slice(
                a_loc, (jnp.int32(0), kb), (rows_per_dev, nb)
            )
            # Gather the full panel on every device: (n, nb).
            c_full = jax.lax.all_gather(c_loc, axes, axis=0, tiled=True)
            d_blk = jax.lax.dynamic_slice(c_full, (kb, jnp.int32(0)), (nb, nb))
            d_blk = 0.5 * (d_blk + d_blk.T)
            l_d = jnp.linalg.cholesky(d_blk)
            # Panel rows: L[:, k] = C @ L_d^{-T}; valid for rows >= kb.
            l_loc = jax.lax.linalg.triangular_solve(
                l_d, c_loc, left_side=False, lower=True, transpose_a=True
            )
            row_mask = (local_rows >= kb)[:, None]
            in_diag = (local_rows >= kb) & (local_rows < kb + nb)
            l_loc = jnp.where(row_mask, l_loc, 0.0)
            # Diagonal-block rows come from L_d (strict upper zeroed).
            local_diag_rows = jnp.clip(local_rows - kb, 0, nb - 1)
            blk_cols = jax.lax.broadcasted_iota(jnp.int32, (rows_per_dev, nb), 1)
            tri_mask = blk_cols <= local_diag_rows[:, None]
            l_loc = jnp.where(
                in_diag[:, None], jnp.where(tri_mask, l_loc, 0.0), l_loc
            )
            # Write the panel into A.
            a_loc = jax.lax.dynamic_update_slice(a_loc, l_loc, (jnp.int32(0), kb))
            # Trailing update on columns > k (masked, static width):
            # A -= L_panel_local @ L_panel_full^T restricted to trailing cols.
            l_full = jax.lax.all_gather(l_loc, axes, axis=0, tiled=True)
            update = l_loc @ l_full.T  # (rows_per_dev, n)
            trailing = (col_ids >= kb + nb)[None, :]
            a_loc = a_loc - jnp.where(trailing, update, 0.0)
            return a_loc

        def step_static(k, a_loc):
            """Unrolled variant: ``k`` is a Python int, so every slice is
            static and the trailing update is an exact-width GEMM."""
            kb = k * nb
            c_loc = a_loc[:, kb : kb + nb]
            c_full = jax.lax.all_gather(c_loc, axes, axis=0, tiled=True)
            d_blk = c_full[kb : kb + nb, :]
            d_blk = 0.5 * (d_blk + d_blk.T)
            l_d = jnp.linalg.cholesky(d_blk)
            l_loc = jax.lax.linalg.triangular_solve(
                l_d, c_loc, left_side=False, lower=True, transpose_a=True
            )
            row_mask = (local_rows >= kb)[:, None]
            in_diag = (local_rows >= kb) & (local_rows < kb + nb)
            l_loc = jnp.where(row_mask, l_loc, 0.0)
            local_diag_rows = jnp.clip(local_rows - kb, 0, nb - 1)
            blk_cols = jax.lax.broadcasted_iota(jnp.int32, (rows_per_dev, nb), 1)
            tri_mask = blk_cols <= local_diag_rows[:, None]
            l_loc = jnp.where(
                in_diag[:, None], jnp.where(tri_mask, l_loc, 0.0), l_loc
            )
            a_loc = a_loc.at[:, kb : kb + nb].set(l_loc)
            if kb + nb < n:
                l_tail = jax.lax.all_gather(
                    l_loc, axes, axis=0, tiled=True
                )[kb + nb :, :]
                update = l_loc @ l_tail.T  # (rows_per_dev, n - kb - nb)
                a_loc = a_loc.at[:, kb + nb :].add(-update)
            return a_loc

        if unroll:
            for k in range(nblocks):
                a_loc = step_static(k, a_loc)
        else:
            a_loc = jax.lax.fori_loop(0, nblocks, step, a_loc)
        # Zero any remaining strictly-upper garbage.
        upper = col_ids[None, :] > local_rows[:, None]
        return jnp.where(upper, 0.0, a_loc)

    return factorize(gram)


def _cyclic_row_permutation(nblocks: int, nb: int, num_devices: int):
    """Natural→cyclic storage permutation: global row-block ``g`` lives on
    device ``g % P`` at local slot ``g // P``; returns ``(idx, inv)`` such
    that ``A_cyclic = A[idx]`` and ``A = A_cyclic[inv]``."""
    import numpy as np

    blocks_per_dev = nblocks // num_devices
    rows_per_dev = blocks_per_dev * nb
    idx = np.empty(nblocks * nb, dtype=np.int32)
    for g in range(nblocks):
        d, s = g % num_devices, g // num_devices
        pos = d * rows_per_dev + s * nb
        idx[pos : pos + nb] = np.arange(g * nb, (g + 1) * nb)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(idx.size, dtype=np.int32)
    return idx, inv


def distributed_cholesky_cyclic(
    gram: jnp.ndarray,
    *,
    mesh: Mesh,
    block_size: int = 512,
    jitter: float | None = None,
) -> jnp.ndarray:
    """Block-cyclic distributed Cholesky — load-balanced variant of
    :func:`distributed_cholesky`.

    The contiguous row-block layout leaves early devices idle once their
    rows are factorized (or, with full-width masked GEMMs, multiplying
    zeros): per-device trailing-update work is ``n³/(2P)`` FLOPs.  Here
    row-block ``g`` is assigned to device ``g mod P`` (classic ScaLAPACK
    1-D block-cyclic), so the active window shrinks uniformly across
    devices and every per-step panel/GEMM is an exact-width static slice:
    ``n³/(3P)`` per device — the parallel ideal.  Elimination order is
    the natural block order (row permutation is storage only), so the
    returned factor — un-permuted back to natural layout — is EXACTLY
    ``chol(gram)``, drop-in for :func:`distributed_chol_solve`.

    Requires ``n`` divisible by ``P * block_size``; the block loop is
    fully unrolled (static offsets), so keep ``n / block_size`` modest.
    """
    n = gram.shape[0]
    num_devices = mesh.devices.size
    nb = block_size
    assert n % (num_devices * nb) == 0, (
        f"n={n} must be divisible by P*nb={num_devices * nb}"
    )
    nblocks = n // nb
    rows_per_dev = n // num_devices
    P_ = num_devices
    if jitter is None:
        jitter = config.cholesky_jitter
    axes = _flat_axes(mesh)

    import numpy as np

    idx, inv = _cyclic_row_permutation(nblocks, nb, P_)
    idx_j = jnp.asarray(idx)
    inv_j = jnp.asarray(inv)

    # Per-step gather indices: trailing block t (natural order) lives at
    # gathered position (t % P)*H_k + (t//P − s_pan)*nb.  Precomputed as
    # static constants (the unrolled loop bakes them into the program).
    def tail_gather_idx(k):
        s_pan = k // P_
        H = rows_per_dev - s_pan * nb
        rows = []
        for t in range(k + 1, nblocks):
            d, s = t % P_, t // P_
            base = d * H + (s - s_pan) * nb
            rows.append(np.arange(base, base + nb, dtype=np.int32))
        return np.concatenate(rows) if rows else None

    tail_idx = [tail_gather_idx(k) for k in range(nblocks)]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axes, None),
        out_specs=P(axes, None),
    )
    def factorize(a_loc):
        dev = jax.lax.axis_index(axes)
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)[0]
        # Global row-block id of each local row (cyclic assignment).
        local_slot = jax.lax.broadcasted_iota(
            jnp.int32, (rows_per_dev, 1), 0
        )[:, 0] // nb
        g_blocks = local_slot * P_ + dev  # (rows_per_dev,) per-row block id

        if jitter:
            g_rows = g_blocks * nb + (
                jax.lax.broadcasted_iota(jnp.int32, (rows_per_dev, 1), 0)[:, 0]
                % nb
            )
            local_diag = a_loc[jnp.arange(rows_per_dev), g_rows]
            diag_scale = jax.lax.pmean(jnp.mean(local_diag), axes)
            eye_loc = (col_ids[None, :] == g_rows[:, None]).astype(a_loc.dtype)
            a_loc = a_loc + (jitter * diag_scale) * eye_loc

        for k in range(nblocks):
            kb = k * nb
            s_pan = k // P_
            lo = s_pan * nb
            H = rows_per_dev - lo
            owner = k % P_
            c_loc = a_loc[lo:, kb : kb + nb]  # (H, nb) static
            c_full = jax.lax.all_gather(c_loc, axes, axis=0, tiled=True)
            d_blk = c_full[owner * H : owner * H + nb, :]
            d_blk = 0.5 * (d_blk + d_blk.T)
            l_d = jnp.linalg.cholesky(d_blk)
            l_loc = jax.lax.linalg.triangular_solve(
                l_d, c_loc, left_side=False, lower=True, transpose_a=True
            )
            row_blk = g_blocks[lo:]  # (H,) block ids of the sliced rows
            after = (row_blk > k)[:, None]
            at_diag = (row_blk == k)[:, None]
            # Diagonal-block rows take l_d's lower triangle.
            r_in_blk = jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0)[:, 0] % nb
            blk_cols = jax.lax.broadcasted_iota(jnp.int32, (H, nb), 1)
            tri = blk_cols <= r_in_blk[:, None]
            l_loc = jnp.where(
                after, l_loc, jnp.where(at_diag & tri, l_loc, 0.0)
            )
            a_loc = a_loc.at[lo:, kb : kb + nb].set(l_loc)
            if k + 1 < nblocks:
                l_full = jax.lax.all_gather(l_loc, axes, axis=0, tiled=True)
                l_tail = jnp.take(l_full, jnp.asarray(tail_idx[k]), axis=0)
                a_loc = a_loc.at[lo:, kb + nb :].add(-(l_loc @ l_tail.T))
        # Zero any strictly-upper garbage (natural column order).
        g_rows = g_blocks * nb + (
            jax.lax.broadcasted_iota(jnp.int32, (rows_per_dev, 1), 0)[:, 0] % nb
        )
        upper = col_ids[None, :] > g_rows[:, None]
        return jnp.where(upper, 0.0, a_loc)

    chol_cyclic = factorize(gram[idx_j])
    return chol_cyclic[inv_j]


def distributed_cholesky_2d(
    gram: jnp.ndarray,
    *,
    mesh: Mesh,
    block_size: int = 256,
    jitter: float | None = None,
    unroll: bool | None = None,
) -> jnp.ndarray:
    """2-D block-cyclic distributed Cholesky (ScaLAPACK ``pdpotrf``
    layout) over a ``(rows: Pr, cols: Pc)`` mesh with ``Pr | Pc``.

    Matrix block ``(i, j)`` lives on device ``(i mod Pr, j mod Pc)``
    (storage-permuted on the way in/out, natural elimination order — the
    returned factor equals ``chol(gram)`` exactly).  Per step ``k``:

    1. the diagonal block is broadcast (nb² — negligible) and factorized
       redundantly;
    2. the column-``k`` owners solve their exact-width panel slice;
    3. routing by two masked ``psum``s, each moving O(n·nb/Pr) per
       device: a row route along ``cols`` (every device receives the
       panel blocks matching ITS row coordinate) and a transpose route
       along ``rows`` exploiting ``j ≡ c (mod Pc) ⇒ j ≡ c (mod Pr)``
       (the blocks a device needs for its local COLUMNS all live at row
       coordinate ``c mod Pr``);
    4. the trailing update is one exact-width local GEMM — n³/(3P)
       FLOPs per device, cyclic load balance.

    Communication per device is O(n²/Pr) total vs O(n²) for the 1-D
    variants: on a square mesh ``Pr = √P`` this is the classic
    O(n²/√P).

    ``unroll=True`` (default for <= 128 block-columns) bakes every step's
    slice offsets and routing indices into the program as constants —
    exact-width GEMMs, n³/(3P) FLOPs per device.  Above 128 block-columns
    a MASKED ``fori_loop`` body takes over: dynamic
    slice offsets, full-width local GEMMs with zero-masked stale blocks —
    ~3x the ideal FLOPs but a single compiled program at ANY n, keeping
    the O(n²/Pr) communication advantage at north-star sizes (e.g.
    N=1e5 / nb=256 = 391 block-columns).
    """
    names = mesh.axis_names
    if len(names) != 2:
        raise ValueError("distributed_cholesky_2d needs a 2-D mesh")
    rn, cn = names
    Pr, Pc = mesh.shape[rn], mesh.shape[cn]
    if Pc % Pr != 0:
        raise ValueError(f"mesh cols ({Pc}) must be a multiple of rows ({Pr})")
    n = gram.shape[0]
    nb = block_size
    assert n % (nb * Pr) == 0 and n % (nb * Pc) == 0, (
        f"n={n} must be divisible by nb*Pr={nb * Pr} and nb*Pc={nb * Pc}"
    )
    nblocks = n // nb
    rows_per_dev = n // Pr
    cols_per_dev = n // Pc
    m_ratio = Pc // Pr
    if jitter is None:
        jitter = config.cholesky_jitter
    if unroll is None:
        unroll = nblocks <= 128
    hi = jax.lax.Precision.HIGHEST

    import numpy as np

    idx_r, inv_r = _cyclic_row_permutation(nblocks, nb, Pr)
    idx_c, inv_c = _cyclic_row_permutation(nblocks, nb, Pc)
    idx_r_j, inv_r_j = jnp.asarray(idx_r), jnp.asarray(inv_r)
    idx_c_j, inv_c_j = jnp.asarray(idx_c), jnp.asarray(inv_c)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(rn, cn),
        out_specs=P(rn, cn),
    )
    def factorize(a_loc):
        r = jax.lax.axis_index(rn)
        c = jax.lax.axis_index(cn)
        li = jax.lax.broadcasted_iota(jnp.int32, (rows_per_dev, 1), 0)[:, 0]
        lj = jax.lax.broadcasted_iota(jnp.int32, (1, cols_per_dev), 1)[0]
        g_row = (li // nb * Pr + r) * nb + li % nb  # global row ids
        g_col = (lj // nb * Pc + c) * nb + lj % nb  # global col ids
        diag_mask = (g_col[None, :] == g_row[:, None]).astype(a_loc.dtype)

        if jitter:
            local_sum = jnp.sum(a_loc * diag_mask)
            diag_scale = jax.lax.psum(local_sum, (rn, cn)) / n
            a_loc = a_loc + (jitter * diag_scale) * diag_mask

        if not unroll:
            # Masked fori_loop body: dynamic slice offsets, full-width
            # local GEMM with zero-masked stale blocks — one compiled
            # program at any nblocks (the unrolled path's compile time
            # is O(nblocks); this one is O(1)).
            gb_all = (li // nb) * Pr + r  # (rows_per_dev,) row-block ids
            rin_all = li % nb
            bcols_all = jax.lax.broadcasted_iota(
                jnp.int32, (rows_per_dev, nb), 1
            )
            tri_all = bcols_all <= rin_all[:, None]
            ts_all = jax.lax.broadcasted_iota(
                jnp.int32, (cols_per_dev // nb, 1), 0
            )[:, 0]
            src_slot = ts_all * m_ratio + (c // Pr)  # (n_col_blocks,)
            pos_all = jnp.clip(
                src_slot[:, None] * nb + jnp.arange(nb)[None, :],
                0, rows_per_dev - 1,
            ).reshape(-1)
            jblk_all = ts_all * Pc + c  # global col-block ids of my cols

            def step(k, a_loc):
                kr, kc = jnp.mod(k, Pr), jnp.mod(k, Pc)
                lo_r = (k // Pr) * nb
                lo_c = (k // Pc) * nb
                z0 = jnp.zeros((), lo_c.dtype)
                on_kc = c == kc
                cpan = jax.lax.dynamic_slice(
                    a_loc, (z0, lo_c), (rows_per_dev, nb)
                )
                d_blk = jax.lax.psum(
                    jnp.where(
                        (r == kr) & on_kc,
                        jax.lax.dynamic_slice(
                            cpan, (lo_r, z0), (nb, nb)
                        ),
                        0.0,
                    ),
                    (rn, cn),
                )
                d_blk = 0.5 * (d_blk + d_blk.T)
                l_d = jnp.linalg.cholesky(d_blk)
                l_pan = jax.lax.linalg.triangular_solve(
                    l_d, cpan, left_side=False, lower=True, transpose_a=True
                )
                after = (gb_all > k)[:, None]
                at_diag = (gb_all == k)[:, None]
                l_masked = jnp.where(
                    after, l_pan, jnp.where(at_diag & tri_all, l_pan, 0.0)
                )
                # Rows with gb < k get zeros written into column block k
                # — that region is strictly upper and dead from here on.
                new_col = jnp.where(on_kc, l_masked, cpan)
                a_loc = jax.lax.dynamic_update_slice(
                    a_loc, new_col, (z0, lo_c)
                )
                l_trail = jnp.where(after, l_masked, 0.0)
                # Row route + transpose route (see the unrolled path).
                row_pan = jax.lax.psum(jnp.where(on_kc, l_trail, 0.0), cn)
                col_full = jax.lax.psum(
                    jnp.where(r == jnp.mod(c, Pr), row_pan, 0.0), rn
                )
                l_col = jnp.take(col_full, pos_all, axis=0)
                keep = (jblk_all > k)[:, None, None]
                l_col = (
                    l_col.reshape(-1, nb, nb)
                    * keep.astype(l_col.dtype)
                ).reshape(-1, nb)
                # Stale rows/cols contribute exact zeros, so the
                # full-width GEMM needs no further masking.
                upd = jnp.matmul(row_pan, l_col.T, precision=hi)
                return a_loc - upd

            a_loc = jax.lax.fori_loop(0, nblocks, step, a_loc)
            upper = g_col[None, :] > g_row[:, None]
            return jnp.where(upper, 0.0, a_loc)

        for k in range(nblocks):
            kr, kc = k % Pr, k % Pc
            lo_r = (k // Pr) * nb
            lo_c = (k // Pc) * nb
            Hr = rows_per_dev - lo_r
            on_kc = c == kc
            cpan = a_loc[lo_r:, lo_c : lo_c + nb]  # (Hr, nb) static slice
            # Diagonal block (position 0 of the slice on its owner).
            d_blk = jax.lax.psum(
                jnp.where((r == kr) & on_kc, cpan[:nb], 0.0), (rn, cn)
            )
            d_blk = 0.5 * (d_blk + d_blk.T)
            l_d = jnp.linalg.cholesky(d_blk)
            l_pan = jax.lax.linalg.triangular_solve(
                l_d, cpan, left_side=False, lower=True, transpose_a=True
            )
            # Global block ids of the slice rows (cyclic by Pr).
            gb = ((lo_r // nb) + jax.lax.broadcasted_iota(jnp.int32, (Hr, 1), 0)[:, 0] // nb) * Pr + r
            after = (gb > k)[:, None]
            at_diag = (gb == k)[:, None]
            rin = jax.lax.broadcasted_iota(jnp.int32, (Hr, 1), 0)[:, 0] % nb
            bcols = jax.lax.broadcasted_iota(jnp.int32, (Hr, nb), 1)
            tri = bcols <= rin[:, None]
            l_masked = jnp.where(after, l_pan, jnp.where(at_diag & tri, l_pan, 0.0))
            # Write the finished panel back on its owning column.
            cur = a_loc[lo_r:, lo_c : lo_c + nb]
            a_loc = a_loc.at[lo_r:, lo_c : lo_c + nb].set(
                jnp.where(on_kc, l_masked, cur)
            )
            if k + 1 == nblocks:
                continue
            l_trail = jnp.where(after, l_masked, 0.0)
            # Row route: my row blocks' panel slice (O(Hr*nb) comm).
            row_pan = jax.lax.psum(jnp.where(on_kc, l_trail, 0.0), cn)
            # Transpose route: blocks for my COLUMN coordinate live at
            # row coordinate c mod Pr (since Pr | Pc).
            col_full = jax.lax.psum(
                jnp.where(r == (c % Pr), row_pan, 0.0), rn
            )
            # Select my trailing column blocks out of col_full: local
            # col slot t (global block j = t*Pc + c) sits at source slot
            # t*m_ratio + c//Pr, offset by the slice base k//Pr.
            t0 = k // Pc
            ts = np.arange(t0, cols_per_dev // nb)
            src_slot = jnp.asarray(ts)[:, None] * m_ratio + (c // Pr)
            pos = (src_slot - (k // Pr)) * nb + jnp.arange(nb)[None, :]
            pos = jnp.clip(pos, 0, Hr - 1)
            l_col = col_full[pos.reshape(-1)]  # (len(ts)*nb, nb)
            # Mask stale column blocks (j <= k) — also guards clipping.
            jblk = jnp.asarray(ts) * Pc + c  # (len(ts),)
            keep = (jblk > k)[:, None, None]
            l_col = (l_col.reshape(len(ts), nb, nb) * keep).reshape(-1, nb)
            # Left operand is the ROW-ROUTED panel — the local l_trail is
            # only meaningful on the owning column.
            upd = jnp.matmul(row_pan, l_col.T, precision=hi)
            a_loc = a_loc.at[lo_r:, lo_c:].add(-upd)
        upper = g_col[None, :] > g_row[:, None]
        return jnp.where(upper, 0.0, a_loc)

    chol_c = factorize(gram[idx_r_j][:, idx_c_j])
    return chol_c[inv_r_j][:, inv_c_j]


def distributed_tri_solve(
    chol: jnp.ndarray,
    rhs: jnp.ndarray,
    *,
    mesh: Mesh,
    block_size: int = 512,
    transpose: bool = False,
) -> jnp.ndarray:
    """Solve ``L y = rhs`` (or ``L^T y = rhs`` with ``transpose=True``)
    with the lower factor ``L`` row-sharded over ``mesh``.

    ``rhs``: ``(n,)`` or ``(n, m)`` replicated (multi-RHS supported — the
    building block for incremental Schur extension, where the new cross
    block is an ``(n, m)`` triangular solve).  Returns replicated ``y``.
    Blocked forward/backward substitution with ``psum`` broadcasts.
    """
    n = chol.shape[0]
    num_devices = mesh.devices.size
    nb = block_size
    nblocks = n // nb
    rows_per_dev = n // num_devices
    axes = _flat_axes(mesh)
    vector = rhs.ndim == 1
    r2 = rhs[:, None] if vector else rhs
    m = r2.shape[1]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axes, None), P(None, None)),
        out_specs=P(None, None),
    )
    def solve(l_loc, r):
        dev = jax.lax.axis_index(axes)
        my_first_row = dev * rows_per_dev
        local_rows = jax.lax.broadcasted_iota(
            jnp.int32, (rows_per_dev, 1), 0
        )[:, 0] + my_first_row

        def extract_block(kb):
            local_off = jnp.clip(kb - my_first_row, 0, rows_per_dev - nb)
            rows = jax.lax.dynamic_slice(l_loc, (local_off, kb), (nb, nb))
            owner = (kb >= my_first_row) & (kb < my_first_row + rows_per_dev)
            return jax.lax.psum(jnp.where(owner, rows, 0.0), axes)

        if not transpose:
            # Right-looking substitution: after solving block k, every
            # device folds L[local rows, k-block] @ y_k into a LOCAL
            # accumulator, so step k only reads the owner's accumulated
            # rows — O(rows_per_dev * nb * m) per step per device, i.e.
            # O(n^2 m / P) total (never the full (nb, n) @ (n, m)).

            def fwd_step(k, carry):
                y, acc = carry
                kb = jnp.int32(k * nb)
                l_kk = extract_block(kb)
                local_off = jnp.clip(kb - my_first_row, 0, rows_per_dev - nb)
                owner = (kb >= my_first_row) & (
                    kb < my_first_row + rows_per_dev
                )
                acc_rows = jax.lax.dynamic_slice(
                    acc, (local_off, jnp.int32(0)), (nb, m)
                )
                s = jax.lax.psum(jnp.where(owner, acc_rows, 0.0), axes)
                r_k = jax.lax.dynamic_slice(r, (kb, jnp.int32(0)), (nb, m))
                y_k = jax.lax.linalg.triangular_solve(
                    l_kk, r_k - s, left_side=True, lower=True
                )
                l_col = jax.lax.dynamic_slice(
                    l_loc, (jnp.int32(0), kb), (rows_per_dev, nb)
                )
                acc = acc + l_col @ y_k
                y = jax.lax.dynamic_update_slice(y, y_k, (kb, jnp.int32(0)))
                return y, acc

            acc0 = jax.lax.pcast(
                jnp.zeros((rows_per_dev, m), r.dtype), axes, to="varying"
            )
            y, _ = jax.lax.fori_loop(
                0, nblocks, fwd_step, (jnp.zeros_like(r), acc0)
            )
            return y

        def bwd_step(i, x):
            kb = jnp.int32((nblocks - 1 - i) * nb)
            l_kk = extract_block(kb)
            l_col = jax.lax.dynamic_slice(
                l_loc, (jnp.int32(0), kb), (rows_per_dev, nb)
            )
            x_local = jax.lax.dynamic_slice(
                x, (my_first_row, jnp.int32(0)), (rows_per_dev, m)
            )
            mask = (local_rows >= kb + nb).astype(x.dtype)[:, None]
            s = jax.lax.psum(l_col.T @ (x_local * mask), axes)
            r_k = jax.lax.dynamic_slice(r, (kb, jnp.int32(0)), (nb, m))
            x_k = jax.lax.linalg.triangular_solve(
                l_kk, r_k - s, left_side=True, lower=True, transpose_a=True
            )
            return jax.lax.dynamic_update_slice(x, x_k, (kb, jnp.int32(0)))

        return jax.lax.fori_loop(0, nblocks, bwd_step, jnp.zeros_like(r))

    out = solve(chol, r2)
    return out[:, 0] if vector else out


def distributed_chol_solve(
    chol: jnp.ndarray, rhs: jnp.ndarray, *, mesh: Mesh, block_size: int = 512
) -> jnp.ndarray:
    """Solve ``(L L^T) x = rhs`` with ``L`` row-sharded over ``mesh``.

    ``rhs``: ``(n,)`` replicated.  Returns replicated ``x``.
    Blocked forward/backward substitution with ``psum`` broadcasts.
    """
    n = chol.shape[0]
    num_devices = mesh.devices.size
    nb = block_size
    nblocks = n // nb
    rows_per_dev = n // num_devices
    axes = _flat_axes(mesh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axes, None), P(None,)),
        out_specs=P(None,),
    )
    def solve(l_loc, r):
        r = r.reshape(n)
        dev = jax.lax.axis_index(axes)
        my_first_row = dev * rows_per_dev
        local_rows = jax.lax.broadcasted_iota(
            jnp.int32, (rows_per_dev, 1), 0
        )[:, 0] + my_first_row

        def extract_block(kb):
            """(nb, nb) diagonal block of L at block kb, on every device."""
            local_off = jnp.clip(kb - my_first_row, 0, rows_per_dev - nb)
            rows = jax.lax.dynamic_slice(
                l_loc, (local_off, kb), (nb, nb)
            )
            owner = (kb >= my_first_row) & (kb < my_first_row + rows_per_dev)
            return jax.lax.psum(
                jnp.where(owner, rows, 0.0), axes
            )

        # Forward: L y = r.  Right-looking: each device folds its local
        # column block against the freshly solved y_k into a local
        # accumulator — O(n^2 / P) per device, not a redundant O(n^2).
        def fwd_step(k, carry):
            y, acc = carry
            kb = jnp.int32(k * nb)
            l_kk = extract_block(kb)
            local_off = jnp.clip(kb - my_first_row, 0, rows_per_dev - nb)
            owner = (kb >= my_first_row) & (kb < my_first_row + rows_per_dev)
            acc_rows = jax.lax.dynamic_slice(acc, (local_off,), (nb,))
            s = jax.lax.psum(jnp.where(owner, acc_rows, 0.0), axes)
            r_k = jax.lax.dynamic_slice(r, (kb,), (nb,))
            y_k = jax.lax.linalg.triangular_solve(
                l_kk, (r_k - s)[:, None], left_side=True, lower=True
            )[:, 0]
            l_col = jax.lax.dynamic_slice(
                l_loc, (jnp.int32(0), kb), (rows_per_dev, nb)
            )
            acc = acc + l_col @ y_k
            return jax.lax.dynamic_update_slice(y, y_k, (kb,)), acc

        acc0 = jax.lax.pcast(
            jnp.zeros((rows_per_dev,), r.dtype), axes, to="varying"
        )
        y, _ = jax.lax.fori_loop(
            0, nblocks, fwd_step, (jnp.zeros_like(r), acc0)
        )

        # Backward: L^T x = y.  Column block k of L is row-distributed:
        # each device contributes L_loc[:, k-block]^T @ x_local_rows.
        def bwd_step(i, x):
            kb = jnp.int32((nblocks - 1 - i) * nb)
            l_kk = extract_block(kb)
            l_col = jax.lax.dynamic_slice(l_loc, (jnp.int32(0), kb), (rows_per_dev, nb))
            x_local = jax.lax.dynamic_slice(
                x, (my_first_row,), (rows_per_dev,)
            )
            mask = (local_rows >= kb + nb).astype(x.dtype)
            s = jax.lax.psum(l_col.T @ (x_local * mask), axes)
            y_k = jax.lax.dynamic_slice(y, (kb,), (nb,))
            x_k = jax.lax.linalg.triangular_solve(
                l_kk, (y_k - s)[:, None], left_side=True, lower=True,
                transpose_a=True,
            )[:, 0]
            return jax.lax.dynamic_update_slice(x, x_k, (kb,))

        x = jax.lax.fori_loop(0, nblocks, bwd_step, jnp.zeros_like(r))
        return x.reshape(rhs.shape)

    return solve(chol, rhs)
