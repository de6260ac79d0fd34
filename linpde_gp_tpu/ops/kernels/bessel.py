"""Modified Bessel function of the second kind and the general-``nu``
Matérn evaluation path.

Capability parity: probnum's numpy ``Matern`` supports arbitrary
``nu > 0`` via ``scipy.special.kv``; the reference's jax path raises for
non-half-integer ``nu`` (``covfuncs/_matern.py:46``).  Here the general
path is jittable on every backend: ``K_nu`` is evaluated through a host
``pure_callback`` into scipy, and a ``custom_jvp`` built from the Bessel
recurrence ``K_nu'(x) = -(K_{nu-1}(x) + K_{nu+1}(x)) / 2`` makes the
callback differentiable to arbitrary order — so the autodiff diffop
fallback (``ops/transforms/autodiff.py``) works on general-``nu``
Matérn kernels, which even the reference's numpy layer cannot do.

Hot-path note: this is a parity/correctness path, not a hot path — each
``kv`` call round-trips device→host.  Half-integer ``nu`` (the only
family the reference exercises in experiments) keeps the closed-form
polynomial chain that XLA fuses.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _kv_host(v: float, x: np.ndarray) -> np.ndarray:
    import scipy.special

    return scipy.special.kv(v, x).astype(x.dtype, copy=False)


@partial(jax.custom_jvp, nondiff_argnums=(0,))
def kv(v: float, x: jnp.ndarray) -> jnp.ndarray:
    """``K_v(x)`` elementwise, jittable via host callback."""
    v = float(v)
    x = jnp.asarray(x)
    dtype = jnp.result_type(x, jnp.float32)
    x = x.astype(dtype)
    return jax.pure_callback(
        partial(_kv_host, v),
        jax.ShapeDtypeStruct(x.shape, dtype),
        x,
        vmap_method="expand_dims",
    )


@kv.defjvp
def _kv_jvp(v, primals, tangents):
    (x,) = primals
    (dx,) = tangents
    primal = kv(v, x)
    # DLMF 10.29.2; each term is again a `kv`, so higher-order autodiff
    # (e.g. Laplacian fallbacks) recurses through the same rule.
    deriv = -0.5 * (kv(v - 1.0, x) + kv(v + 1.0, x))
    return primal, deriv * dx


def matern_bessel(nu: float, t: jnp.ndarray) -> jnp.ndarray:
    r"""``2^{1-nu}/Gamma(nu) \cdot t^nu \cdot K_nu(t)`` with the
    ``t -> 0`` limit of 1, where ``t = sqrt(2 nu) ||x0 - x1|| / l``.
    """
    nu = float(nu)
    log_norm = (1.0 - nu) * math.log(2.0) - math.lgamma(nu)
    t = jnp.asarray(t)
    # Double-where: keep the untaken branch NaN-free for grads at t == 0.
    t_safe = jnp.where(t > 0, t, jnp.ones((), t.dtype))
    val = math.exp(log_norm) * t_safe**nu * kv(nu, t_safe)
    return jnp.where(t > 0, val, jnp.ones((), t.dtype))
