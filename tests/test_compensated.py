"""Compensated (float-float) streaming Gram evaluation.

The reference holds float64 machine-precision posterior parity
(``tests/linpde_gp/randprocs/test_posterior_gp.py:152-162``); in float32
the evaluation chain carries a coherent ~1e-6 per-entry error that makes
the computed Gram indefinite at scale.  The compensated mode
(``ops/ff.py`` + ``compensated=True`` in ``ops/gram``) must bring
the per-entry error to ~1e-12 so small-noise conditioning survives at
N = 1e5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import linpde_gp_tpu as lgt
from linpde_gp_tpu.ops import ff
from linpde_gp_tpu.ops.gram import (
    kernel_term_specs,
    terms_gram,
    xla_gram_matvec,
)
from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel
from linpde_gp_tpu.ops import diffops


def _heat_spec():
    prior_cov = 1.0 * lgt.kernels.TensorProduct(
        lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
        lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
    )
    H = diffops.HeatOperator((2,), alpha=0.1)
    k_hh = apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, prior_cov, argnum=1), argnum=0
    )
    return k_hh, kernel_term_specs(k_hh)


def _f64_gram(spec, X0, X1):
    """Float64 oracle via the plain dense evaluator."""
    from linpde_gp_tpu.ops.gram import _collapse_terms, _eval_groups

    scale, terms = spec
    groups = _collapse_terms(tuple(terms))
    x0 = jnp.asarray(X0, jnp.float64)
    x1 = jnp.asarray(X1, jnp.float64)
    acc = _eval_groups(groups, lambda i: x0[:, None, i] - x1[None, :, i])
    return scale * np.asarray(acc, np.float64)


# -- ff primitives -----------------------------------------------------------


def test_ff_exp_accuracy():
    rng = np.random.default_rng(0)
    x32 = rng.uniform(-40.0, 2.0, 4096).astype(np.float32)
    eh, el = ff.ff_exp((jnp.asarray(x32), jnp.zeros(4096, jnp.float32)))
    got = np.asarray(eh, np.float64) + np.asarray(el, np.float64)
    ref = np.exp(x32.astype(np.float64))
    # degree-10 exp: ~2e-12 truncation; requirement is 1e-10.
    assert np.max(np.abs(got - ref) / ref) < 1e-11


def test_ff_mul_add_chain():
    rng = np.random.default_rng(1)
    a = rng.uniform(-3, 3, 4096).astype(np.float32)
    b = rng.uniform(-3, 3, 4096).astype(np.float32)
    d = ff.two_diff(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) - b.astype(np.float64)
    got = np.asarray(d[0], np.float64) + np.asarray(d[1], np.float64)
    np.testing.assert_array_equal(got, exact)  # error-free

    s = ff.ff_scale(d, 1.7320508075688772)
    exact_s = exact * 1.7320508075688772
    got = np.asarray(s[0], np.float64) + np.asarray(s[1], np.float64)
    assert np.max(np.abs(got - exact_s) / np.abs(exact_s)) < 1e-13


def test_ff_exp_underflow_clamp():
    x = jnp.asarray(np.float32([-100.0, -87.0, -50.0, 0.0]))
    eh, el = ff.ff_exp((x, jnp.zeros_like(x)))
    out = np.asarray(eh + el, np.float64)
    assert np.all(np.isfinite(out))
    assert out[0] <= 1e-37
    assert abs(out[3] - 1.0) < 1e-13


# -- compensated Gram / matvec ----------------------------------------------


@pytest.mark.parametrize("n", [192, 1024])
def test_compensated_gram_entry_error(n):
    k_hh, spec = _heat_spec()
    scale, terms = spec
    rng = np.random.default_rng(2)
    X = np.stack(
        [rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1
    ).astype(np.float32)
    ref = _f64_gram(spec, X, X)

    plain = scale * np.asarray(
        terms_gram(terms, jnp.asarray(X), jnp.asarray(X)),
        np.float64,
    )
    comp = scale * np.asarray(
        terms_gram(terms, jnp.asarray(X), jnp.asarray(X), compensated=True),
        np.float64,
    )
    k0 = ref[0, 0]
    err_comp = np.max(np.abs(comp - ref)) / k0
    # The compensated internal chain is ~1e-13; the final f32 rounding of
    # each stored entry (~eps32/2, but INCOHERENT) dominates.
    assert err_comp < 1e-7
    # Internal chain actually improved things: coherent norm ||E||_2 must
    # shrink vs plain f32 (the definiteness criterion).
    norm_plain = np.linalg.norm(plain - ref, 2)
    norm_comp = np.linalg.norm(comp - ref, 2)
    assert norm_comp <= norm_plain * 1.5  # never worse
    assert np.max(np.abs(comp - comp.T)) == 0.0  # exactly symmetric


def test_compensated_matvec_full_precision():
    """The streaming matvec keeps BOTH ff planes through the contraction
    — effective entry error ~1e-12, i.e. the λ_min drift criterion."""
    k_hh, spec = _heat_spec()
    scale, terms = spec
    n = 768
    rng = np.random.default_rng(3)
    X = np.stack(
        [rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1
    ).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    ref = _f64_gram(spec, X, X) @ v.astype(np.float64)

    out = scale * np.asarray(
        xla_gram_matvec(
            terms, jnp.asarray(X), jnp.asarray(X), jnp.asarray(v),
            compensated=True,
        ),
        np.float64,
    )
    scale_ref = np.max(np.abs(ref))
    err = np.max(np.abs(out - ref)) / scale_ref
    # f32 row-sum rounding only.
    assert err < 3e-6

    out_plain = scale * np.asarray(
        xla_gram_matvec(
            terms, jnp.asarray(X), jnp.asarray(X), jnp.asarray(v),
            compensated=False,
        ),
        np.float64,
    )
    err_plain = np.max(np.abs(out_plain - ref)) / scale_ref
    assert err <= err_plain * 2.0  # compensation never hurts


def test_compensated_gram_coherent_error_floor():
    """Definiteness criterion: on the CPU (accurate libm) the plain f32
    chain is already ~eps-level, so here we verify the compensated chain
    against a TIGHT absolute bound by reading the internal ff planes
    through the dense evaluator (no final f32 entry rounding)."""
    from linpde_gp_tpu.ops.gram import _collapse_terms, _eval_groups_ff

    k_hh, spec = _heat_spec()
    scale, terms = spec
    n = 512
    rng = np.random.default_rng(4)
    X = np.stack(
        [rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1
    ).astype(np.float32)
    ref = _f64_gram(spec, X, X)

    groups = _collapse_terms(tuple(terms))
    x = jnp.asarray(X)
    hi, lo = _eval_groups_ff(
        groups, lambda i: (x[:, None, i], x[None, :, i])
    )
    got = scale * (np.asarray(hi, np.float64) + np.asarray(lo, np.float64))
    err = np.max(np.abs(got - ref)) / ref[0, 0]
    assert err < 1e-10  # requirement: >=1e3 below the 1e-6 plain floor


def test_wendland_compensated():
    """Compact-support cutoff stays exact in ff (mask on the hi/lo pair)."""
    k = lgt.kernels.WendlandCovarianceFunction((), k=1, lengthscales=0.5)
    spec = kernel_term_specs(k)
    assert spec is not None
    scale, terms = spec
    rng = np.random.default_rng(5)
    X = rng.uniform(-1.0, 1.0, (256, 1)).astype(np.float32)
    ref = _f64_gram(spec, X, X)
    comp = scale * np.asarray(
        terms_gram(terms, jnp.asarray(X), jnp.asarray(X), compensated=True),
        np.float64,
    )
    assert np.max(np.abs(comp - ref)) / ref[0, 0] < 1e-7
    # support pattern identical
    np.testing.assert_array_equal(comp == 0.0, ref == 0.0)
