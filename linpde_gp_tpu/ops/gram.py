"""Gram assembly and Gram-free matvecs of the closed-form kernel family.

The reference offloads large kernel-matrix reductions to KeOps
(``pykeops`` ``LazyTensor``; consumed at ``covfuncs/_tensor_product.py:
56-62,111-130`` and throughout the Matérn diffop kernels) — a C++/CUDA
lazy map-reduce.  Here the same reductions run as:

- :func:`xla_gram_matvec` / :func:`terms_gram`: the closed form in plain
  ``jax.numpy``, which XLA fuses — on the GPU a matvec becomes a
  row-blocked reduction (one column) or a pair block plus a GEMM
  (several columns), assembly one write per entry;
- the native C++/OpenMP host engine (``native/``) on the CPU;
- :func:`make_banded_matvec` for compactly supported kernels.

``linpde_gp_tpu.backend.route`` picks one.  Covers the entire closed-form
kernel family of ``transforms/product.py`` (ExpQuad / half-integer Matérn
/ Wendland / TensorProduct and all their diffop transforms): each factor
is ``prefactor * P(t) * exp(-t or -t^2) * sign^parity``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..config import config

# A term spec is a tuple: (coeff, factors) with factors a tuple of
# (kind, scale, poly, parity, prefactor) per input dimension; kind is
# "matern" (t = scale*|d|, exp(-t)), "expquad" (z = scale*d, exp(-z^2))
# or "wendland" (t = scale*|d|, cut off at t > 1).
TermSpec = tuple

_HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _collapse_terms(terms: tuple) -> tuple:
    """Merge sum-of-products terms into multivariate polynomial groups.

    Terms whose factors share the same per-dimension ``(kind, scale)``
    and parity vector differ only in their polynomial parts, so their
    sum is ONE multivariate polynomial: the sum of outer products of the
    per-factor coefficient vectors (prefactors and the term coefficient
    folded in, accumulated in float64).  Each group then costs a single
    ``exp``/``abs`` per distinct ``(dim, kind, scale)`` plus one nested
    Horner sweep over the coefficient tensor — e.g. the heat operator's
    9-term ``H k H*`` closed form collapses to 3 groups sharing 2
    transcendentals, ~4x fewer operations per pair than evaluating
    factors term by term.

    Returns ``((dims_key, parity, coeff_tensor_nested_tuple), ...)``.
    """
    groups: dict = {}
    order: list = []
    for coeff, factors in terms:
        dims_key = tuple((f[0], float(f[1])) for f in factors)
        # Parity (an explicit sign(d) factor) applies to the |d|-variable
        # families (matern, wendland); expquad polynomials are in the
        # signed variable already.
        parity = tuple(
            int(f[3]) if f[0] in ("matern", "wendland") else 0 for f in factors
        )
        key = (dims_key, parity)
        c = float(coeff)
        tensor = np.asarray([1.0], dtype=np.float64)
        for f in factors:
            c *= float(f[4])
            tensor = np.multiply.outer(tensor, np.asarray(f[2], np.float64))
        tensor = c * tensor[0]
        if key not in groups:
            groups[key] = tensor
            order.append(key)
        else:
            prev = groups[key]
            shape = tuple(max(a, b) for a, b in zip(prev.shape, tensor.shape))
            merged = np.zeros(shape, np.float64)
            merged[tuple(slice(s) for s in prev.shape)] += prev
            merged[tuple(slice(s) for s in tensor.shape)] += tensor
            groups[key] = merged

    def nest(a):
        if a.ndim == 1:
            return tuple(float(v) for v in a)
        return tuple(nest(sub) for sub in a)

    return tuple((key[0], key[1], nest(groups[key])) for key in order)


def _horner_1d(coeffs, t):
    acc = jnp.full_like(t, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = acc * t + c
    return acc


def _horner_nd(C, ts, axis=0):
    """Nested Horner evaluation of a multivariate coefficient tensor."""
    if axis == len(ts) - 1:
        return _horner_1d(C, ts[axis])
    subs = [_horner_nd(sub, ts, axis + 1) for sub in C]
    acc = subs[-1]
    t = ts[axis]
    for s in reversed(subs[:-1]):
        acc = acc * t + s
    return acc


def _horner_1d_ff(coeffs, t, dtype):
    from . import ff

    c_hi, c_lo = ff.ff_const(coeffs[-1], dtype)
    acc = (jnp.full_like(t[0], c_hi), jnp.full_like(t[0], c_lo))
    for c in reversed(coeffs[:-1]):
        c_hi, c_lo = ff.ff_const(c, dtype)
        acc = ff.ff_add_const(ff.ff_mul(acc, t), c_hi, c_lo)
    return acc


def _horner_nd_ff(C, ts, dtype, axis=0):
    from . import ff

    if axis == len(ts) - 1:
        return _horner_1d_ff(C, ts[axis], dtype)
    subs = [_horner_nd_ff(sub, ts, dtype, axis + 1) for sub in C]
    acc = subs[-1]
    t = ts[axis]
    for s in reversed(subs[:-1]):
        acc = ff.ff_add(ff.ff_mul(acc, t), s)
    return acc


def _eval_groups_ff(groups, d_fn):
    """Compensated (float-float) variant of :func:`_eval_groups`.

    ``d_fn(i)`` returns the RAW per-dimension pairwise difference
    operands ``(a_i, b_i)`` (broadcastable); the difference, scaled
    distance, Horner chains, exponentials and term sum are all carried
    in hi/lo pairs (``ops/ff.py``), dropping the per-entry evaluation
    error of float32 from ~1e-6 to ~1e-13.  Returns the ``(hi, lo)``
    pair so matvec callers can contract both planes.
    """
    from . import ff

    d_cache: dict = {}
    t_cache: dict = {}
    e_cache: dict = {}
    s_cache: dict = {}

    def dff(i):
        if i not in d_cache:
            a, b = d_fn(i)
            d_cache[i] = ff.two_diff(a, b)
        return d_cache[i]

    acc = None
    for dims_key, parity, C in groups:
        dtype = None
        ts = []
        env = None
        for i, (kind, scale) in enumerate(dims_key):
            tk = (i, kind, scale)
            if tk not in t_cache:
                z = ff.ff_scale(dff(i), scale)
                if kind == "matern":
                    t = ff.ff_abs(z)
                    e = ff.ff_exp(ff.ff_neg(t))
                elif kind == "wendland":
                    t = ff.ff_abs(z)
                    inside = (t[0] < 1.0) | ((t[0] == 1.0) & (t[1] <= 0.0))
                    e = (inside.astype(t[0].dtype), jnp.zeros_like(t[0]))
                else:
                    t = z
                    e = ff.ff_exp(ff.ff_neg(ff.ff_sqr(z)))
                t_cache[tk] = t
                e_cache[tk] = e
            ts.append(t_cache[tk])
            env = e_cache[tk] if env is None else ff.ff_mul(env, e_cache[tk])
            dtype = ts[-1][0].dtype
        val = ff.ff_mul(_horner_nd_ff(C, ts, dtype), env)
        for i, p in enumerate(parity):
            if p:
                if i not in s_cache:
                    s_cache[i] = jnp.sign(dff(i)[0])
                val = (val[0] * s_cache[i], val[1] * s_cache[i])
        acc = val if acc is None else ff.ff_add(acc, val)
    return acc


def _eval_groups(groups, d_fn):
    """Evaluate collapsed polynomial groups given per-dimension pairwise
    differences ``d_fn(i)``; transcendentals memoized across groups."""
    d_cache: dict = {}
    t_cache: dict = {}
    e_cache: dict = {}
    s_cache: dict = {}

    def d(i):
        if i not in d_cache:
            d_cache[i] = d_fn(i)
        return d_cache[i]

    acc = None
    for dims_key, parity, C in groups:
        ts = []
        env = None
        for i, (kind, scale) in enumerate(dims_key):
            tk = (i, kind, scale)
            if tk not in t_cache:
                if kind == "matern":
                    t = scale * jnp.abs(d(i))
                    e = jnp.exp(-t)
                elif kind == "wendland":
                    t = scale * jnp.abs(d(i))
                    e = (t <= 1.0).astype(t.dtype)  # compact support cutoff
                else:
                    t = scale * d(i)
                    e = jnp.exp(-(t * t))
                t_cache[tk] = t
                e_cache[tk] = e
            ts.append(t_cache[tk])
            env = e_cache[tk] if env is None else env * e_cache[tk]
        val = _horner_nd(C, ts) * env
        for i, p in enumerate(parity):
            if p:
                if i not in s_cache:
                    s_cache[i] = jnp.sign(d(i))
                val = val * s_cache[i]
        acc = val if acc is None else acc + val
    return acc


def _pair_planes(groups, a_fn, b_fn, compensated):
    """Gram block planes from per-dimension row/column coordinates:
    ``(G,)`` plain, ``(hi, lo)`` compensated."""
    if compensated:
        return _eval_groups_ff(groups, lambda i: (a_fn(i), b_fn(i)))
    return (_eval_groups(groups, lambda i: a_fn(i) - b_fn(i)),)


def _as_points(X):
    X = jnp.asarray(X)
    return X[:, None] if X.ndim == 1 else X


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _contract(planes, V):
    """``sum_p plane_p @ V`` in plain jnp (a fused row sum for one
    column, a ``HIGHEST`` dot otherwise — never TF32)."""
    out = None
    for g in planes:
        if V.shape[1] == 1:
            part = jnp.sum(g * V[:, 0][None, :], axis=1, keepdims=True)
        else:
            part = jnp.matmul(g, V, precision=_HIGHEST)
        out = part if out is None else out + part
    return out


# -- plain XLA ------------------------------------------------------------


def terms_gram(terms, X0, X1, *, compensated: bool | None = None) -> jnp.ndarray:
    """Assemble the ``(n0, n1)`` Gram of a sum-of-products kernel in plain
    ``jax.numpy``: XLA fuses the whole closed form into one write per
    entry, which is all the traffic an assembly can have.

    ``X0``/``X1``: ``(n, d)`` point arrays (``(n,)`` for scalar inputs).
    ``compensated=True`` evaluates every entry in float-float pairs
    (``ops/ff.py``) — ~1e-13 per-entry error at float32 storage cost;
    defaults to ``config.gram_compensated``.
    """
    if compensated is None:
        compensated = config.gram_compensated
    X0, X1 = _as_points(X0), _as_points(X1)
    groups = _collapse_terms(tuple(terms))
    planes = _pair_planes(
        groups, lambda i: X0[:, None, i], lambda i: X1[None, :, i], compensated
    )
    return planes[0] + planes[1] if compensated else planes[0]


def xla_gram_matvec(
    terms, X0, X1, v, *, compensated: bool = False, block_entries: int = 1 << 26
) -> jnp.ndarray:
    """``K(X0, X1) @ v`` WITHOUT materializing the whole Gram — O(n0 * n1)
    compute, O(block_entries + n0 + n1) memory — in plain ``jax.numpy``:
    a ``lax.map`` over row blocks of at most ``block_entries`` pairs (a
    single block for small problems).  For one right-hand side XLA fuses
    each block into a reduction and no pair block reaches device memory;
    for several it writes the block once and contracts it in a GEMM.

    ``v``: ``(n1,)`` or ``(n1, r)``.  ``compensated=True`` evaluates the
    entries in float-float pairs and contracts both planes."""
    X0, X1 = _as_points(X0), _as_points(X1)
    v = jnp.asarray(v)
    vector = v.ndim == 1
    V = v[:, None] if vector else v
    n0, d = X0.shape
    n1 = X1.shape[0]
    groups = _collapse_terms(tuple(terms))

    def rows(x0):
        planes = _pair_planes(
            groups, lambda i: x0[:, None, i], lambda i: X1[None, :, i], compensated
        )
        return _contract(planes, V)

    rb = max(1, min(n0, block_entries // max(n1, 1)))
    if rb >= n0:
        out = rows(X0)
    else:
        nb = -(-n0 // rb)
        X0p = jnp.zeros((nb * rb, d), X0.dtype).at[:n0].set(X0)
        out = jax.lax.map(rows, X0p.reshape(nb, rb, d))
        out = out.reshape(nb * rb, -1)[:n0]
    return out[:, 0] if vector else out


# -- term specs and routing --------------------------------------------------


def kernel_term_specs(kernel) -> tuple[float, tuple] | None:
    """Extract ``(outer_scale, terms)`` from a kernel if it belongs to the
    sum-of-products closed-form family; ``None`` otherwise."""
    from .kernels.arithmetic import ScaledCovarianceFunction
    from .transforms.product import SumOfProductsKernel, transform_product_kernel

    scale = 1.0
    while isinstance(kernel, ScaledCovarianceFunction):
        scale *= kernel.scalar
        kernel = kernel.covfunc
    if isinstance(kernel, SumOfProductsKernel):
        terms = tuple(
            (
                float(c),
                tuple(
                    (f.kind, f.scale, f.poly, f.parity, f.prefactor)
                    for f in factors
                ),
            )
            for c, factors in kernel.terms
        )
        return scale, terms
    # Base kernels: express as the identity transform of themselves.
    sop = transform_product_kernel(kernel, None, None)
    if sop is not None:
        terms = tuple(
            (
                float(c),
                tuple(
                    (f.kind, f.scale, f.poly, f.parity, f.prefactor)
                    for f in factors
                ),
            )
            for c, factors in sop.terms
        )
        return scale, terms
    return None


def _num_points(X, in_ndim):
    return int(np.prod(X.shape[: X.ndim - in_ndim], dtype=np.int64)) if X.ndim > in_ndim else 1


def gram_matrix(kernel, X0, X1=None) -> jnp.ndarray:
    """Assemble ``k(X0, X1)``: the native host engine where
    :func:`linpde_gp_tpu.backend.route` says so, else the fused closed
    form (:func:`terms_gram`) for the sum-of-products family and the
    kernel's own broadcast evaluation for everything else."""
    X0 = jnp.asarray(X0)
    X1 = X0 if X1 is None else jnp.asarray(X1)
    in_ndim = kernel.input_ndim
    n0, n1 = _num_points(X0, in_ndim), _num_points(X1, in_ndim)
    if kernel.output_shape_0 != () or kernel.output_shape_1 != ():
        return kernel.matrix(X0, X1)
    if backend.route("gram", n0=n0, n1=n1) == "native":
        out = _native_gram(kernel, X0.reshape(n0, -1), X1.reshape(n1, -1))
        if out is not None:
            return out
    spec = kernel_term_specs(kernel)
    if spec is None:
        return kernel.matrix(X0, X1)
    scale, terms = spec
    out = terms_gram(terms, X0.reshape(n0, -1), X1.reshape(n1, -1), compensated=False)
    return scale * out if scale != 1.0 else out


def _native_gram(kernel, x0, x1):
    """Host C++/OpenMP Gram assembly (KeOps-equivalent, ``native/``).

    Works under ``jit`` via ``pure_callback``; float64 end-to-end on the
    host, cast to the caller's dtype on the way back.
    """
    from .. import native

    eng = native.engine_for(kernel)
    if eng is None:
        return None
    dtype = jnp.result_type(x0.dtype, x1.dtype)
    out_shape = jax.ShapeDtypeStruct((x0.shape[0], x1.shape[0]), dtype)

    def _cb(a, b):
        return eng.gram(np.asarray(a, np.float64), np.asarray(b, np.float64)).astype(dtype)

    return jax.pure_callback(_cb, out_shape, x0, x1, vmap_method="sequential")


def gram_matvec(spec, X0, X1, v, *, compensated: bool | None = None) -> jnp.ndarray:
    """Gram-free ``scale * K(X0, X1) @ v`` for a ``(scale, terms)`` spec,
    by the route of :func:`linpde_gp_tpu.backend.route`: the native
    C++/OpenMP engine on the host CPU above
    ``config.native_gram_threshold`` (small problems stay in XLA,
    avoiding per-call host callbacks), :func:`xla_gram_matvec` otherwise
    (the GPU route).

    Compact-support (Wendland) kernels: this router accepts TRACED point
    arrays, so it cannot sort points or build the static band schedule —
    callers holding CONCRETE points should use :func:`make_banded_matvec`
    (factory) instead for O(n·band) work; both regressor engines
    (``models/iterative.py``, ``parallel/iterative.py``) route the
    banded schedule themselves.
    """
    scale, terms = spec
    if compensated is None:
        compensated = config.gram_compensated
    n0, n1 = jnp.shape(X0)[0], jnp.shape(X1)[0]
    eng = None
    if backend.route("matvec", n0=n0, n1=n1) == "native":
        from .. import native

        eng = native.engine_for_spec(scale, terms)
    if eng is not None:
        X0 = jnp.asarray(X0)
        v = jnp.asarray(v)
        dtype = jnp.result_type(X0.dtype, v.dtype)
        out_shape = jax.ShapeDtypeStruct(X0.shape[:1] + v.shape[1:], dtype)

        def _cb(a, b, w):
            return eng.matvec(
                np.asarray(a, np.float64),
                np.asarray(b, np.float64),
                np.asarray(w, np.float64),
            ).astype(dtype)

        return jax.pure_callback(
            _cb, out_shape, X0, jnp.asarray(X1), v, vmap_method="sequential"
        )
    out = xla_gram_matvec(terms, X0, X1, v, compensated=bool(compensated))
    return scale * out if scale != 1.0 else out


# -- compact support: banded schedule -----------------------------------------


def compact_support_radius(terms, dim: int = 0) -> float | None:
    """Support radius along input dimension ``dim`` if EVERY term's
    ``dim``-factor is compactly supported (``wendland`` kind: support
    ``|d| <= 1/scale``); ``None`` otherwise.

    The reference routes Wendland through KeOps and never exploits the
    sparsity structurally (``covfuncs/_wendland.py:87-98``); here it
    feeds the banded schedule below.
    """
    radius = 0.0
    for _coeff, factors in terms:
        f = factors[dim]
        if f[0] != "wendland":
            return None
        radius = max(radius, 1.0 / float(f[1]))
    return radius


def band_windows(X0s, n0_real, c1_sorted, radius, tile0, tile1, n0p):
    """Per-row-tile column-tile windows ``[j_lo, j_hi]`` covering all
    real column points within ``radius`` of the tile's rows.  ``X0s``:
    the (padded-size irrelevant) sorted row points; ``c1_sorted``: the
    sorted dim-0 column coordinates.  Padded slots carry ``v = 0``, so
    only real pairs constrain the band."""
    ntiles0 = n0p // tile0
    j_lo = np.zeros(ntiles0, np.int64)
    j_hi = np.zeros(ntiles0, np.int64)
    for it in range(ntiles0):
        rows = X0s[it * tile0 : min((it + 1) * tile0, n0_real), 0]
        if rows.size == 0:  # fully padded row tile: any valid window
            continue
        a = int(np.searchsorted(c1_sorted, rows.min() - radius, "left"))
        b = int(np.searchsorted(c1_sorted, rows.max() + radius, "right"))
        j_lo[it] = a // tile1
        j_hi[it] = max(b - 1, a) // tile1
    return j_lo, j_hi


def band_starts(j_lo, j_hi, ntiles1):
    """``(band, j_start)``: the common window width in column tiles and
    each row tile's first column tile, clipped into the column range."""
    band = int(np.max(j_hi - j_lo + 1))
    j_start = np.clip(np.minimum(j_lo, ntiles1 - band), 0, None).astype(np.int32)
    return band, j_start


def banded_panel_matvec(terms, x0p, j_start, x1p, vp, *, tile0, tile1, band, compensated=False):
    """Unscaled banded ``K @ v`` in plain jnp: row tile ``i`` of ``x0p``
    (``(ntiles0 * tile0, d)``) against its column panel — ``band``
    column tiles of ``x1p``/``vp`` (``(n1p, d)``/``(n1p, r)``, sorted
    along dim 0) starting at tile ``j_start[i]`` — under ``lax.map``.
    ``j_start`` may be traced (one slice per device under ``shard_map``).
    """
    groups = _collapse_terms(tuple(terms))
    d = x0p.shape[1]
    panel = jnp.asarray(j_start)[:, None] * tile1 + jnp.arange(band * tile1)[None, :]

    def one(args):
        x0, cols = args
        x1 = jnp.take(x1p, cols, axis=0)
        planes = _pair_planes(
            groups, lambda i: x0[:, None, i], lambda i: x1[None, :, i], compensated
        )
        return _contract(planes, jnp.take(vp, cols, axis=0))

    out = jax.lax.map(one, (x0p.reshape(-1, tile0, d), panel))
    return out.reshape(x0p.shape[0], -1)


def make_banded_matvec(spec, X0, X1, *, radius: float | None = None, tile0: int | None = None, tile1: int | None = None, compensated: bool | None = None):
    """Factory for a banded gram-free matvec ``v -> scale * K(X0, X1) @ v``
    exploiting compact support: points are sorted by input dimension 0 and
    each row tile visits only the contiguous window of column tiles within
    the support radius — O(n0 * band) pair work instead of O(n0 * n1).

    Because the kernel is EXACTLY zero beyond the radius, the band is
    exact (not an approximation): any tile outside it contributes zero.
    ``X0``/``X1`` must be host (concrete) arrays — the band structure is
    static schedule metadata, computed ahead of trace time; the returned
    closure is jittable and takes/returns vectors in the ORIGINAL point
    order.  ``radius`` defaults to the spec's Wendland support along
    dimension 0 (raises if the dim-0 factors are not compactly supported).
    ``tile0``/``tile1``: band granularity in rows and columns (default
    ``config.band_tile``).
    """
    scale, terms = spec
    if compensated is None:
        compensated = config.gram_compensated
    X0 = np.asarray(X0)
    X1 = np.asarray(X1)
    if X0.ndim == 1:
        X0 = X0[:, None]
    if X1.ndim == 1:
        X1 = X1[:, None]
    if radius is None:
        radius = compact_support_radius(terms, 0)
        if radius is None:
            raise ValueError(
                "kernel is not compactly supported along dim 0; pass radius="
            )
    n0, d = X0.shape
    n1 = X1.shape[0]
    dtype = jnp.result_type(X0.dtype, jnp.zeros((), config.default_dtype).dtype)

    perm0 = np.argsort(X0[:, 0], kind="stable")
    perm1 = np.argsort(X1[:, 0], kind="stable")
    inv0 = np.argsort(perm0)
    X0s = X0[perm0]
    X1s = X1[perm1]

    tile0 = min(tile0 or config.band_tile, n0)
    tile1 = min(tile1 or config.band_tile, n1)
    n0p = _round_up(n0, tile0)
    n1p = _round_up(n1, tile1)
    ntiles1 = n1p // tile1
    j_lo, j_hi = band_windows(X0s, n0, X1s[:, 0], radius, tile0, tile1, n0p)
    band, j_start = band_starts(j_lo, j_hi, ntiles1)
    # Host copies, converted at USE time: the closure may first run
    # inside a jax trace (lax.map / jit / while_loop body), where
    # anything jnp-built would be a tracer that must not outlive it.
    x0_pad = np.zeros((n0p, d))
    x0_pad[:n0] = X0s
    x1_pad = np.zeros((n1p, d))
    x1_pad[:n1] = X1s

    def matvec(v):
        v = jnp.asarray(v)
        vector = v.ndim == 1
        V = v[:, None] if vector else v
        # Per-call dtype promotion: a f64 ``v`` against f32 default
        # points computes in f64 rather than silently downcasting.
        dt = jnp.result_type(dtype, V.dtype)
        vs = jnp.take(V.astype(dt), jnp.asarray(perm1), axis=0)
        vp = jnp.zeros((n1p, V.shape[1]), dt).at[:n1].set(vs)
        out = banded_panel_matvec(
            terms, jnp.asarray(x0_pad, dt), j_start, jnp.asarray(x1_pad, dt), vp,
            tile0=tile0, tile1=tile1, band=band, compensated=bool(compensated),
        )[:n0]
        if scale != 1.0:
            out = scale * out
        out = jnp.take(out, jnp.asarray(inv0), axis=0)
        return out[:, 0] if vector else out

    matvec.band_tiles = band
    matvec.total_tiles = ntiles1
    return matvec
