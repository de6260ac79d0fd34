"""Global configuration for linpde_gp_tpu.

The reference library pins ``jax_enable_x64`` globally (see
``tests/linpde_gp/conftest.py:1-3`` of the reference).  Here precision
is an explicit choice instead:

- ``default_dtype`` tracks ``jax_enable_x64``: float64 when enabled (the
  tests and the GPU main path), float32 otherwise.
- ``cholesky_jitter`` is an explicit nugget added to Gram diagonals before
  factorization.  The reference relies on float64 and ``inset=1e-6`` grid
  hacks instead of a jitter policy; in float32 an explicit jitter is
  required for near-singular Grams from smooth kernels.
- ``quadrature_order`` replaces the reference's adaptive ``scipy.quad``
  fallback (``linfunctls/_integrals.py:38-57``) with fixed-order
  Gauss-Legendre panels: static shapes, jittable.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class _Config:
    #: Jitter added to the Gram diagonal before Cholesky (absolute).
    cholesky_jitter: float = 0.0

    #: Number of Gauss-Legendre nodes per panel for quadrature fallbacks.
    quadrature_order: int = 64

    #: Number of quadrature panels per integration domain.
    quadrature_panels: int = 4

    #: Use blockwise (incremental) triangular solves where possible.
    #: Mirrors the reference's ``block_triangular_solves`` probnum config
    #: flag (``linops/_block.py:8-14``).
    block_triangular_solves: bool = True

    #: Band granularity (rows and columns per tile) of the banded
    #: compact-support matvec (``ops/gram.make_banded_matvec``)
    #: used by both regressor engines: each row tile visits only the
    #: column tiles within the support radius.
    band_tile: int = 512

    #: Compensated (float-float) streaming Gram evaluation: carry the
    #: distance/Horner/exp chains in hi/lo float32 pairs (``ops/ff.py``),
    #: dropping the per-entry evaluation error from ~1e-6 to ~1e-13 of
    #: k(0) at ~20x the arithmetic.  Turn on for small-noise conditioning
    #: at large N in float32 (the plain-f32 error makes the computed Gram
    #: indefinite at ``sigma^2 < ~3e-7 * N * k(0)``); float64 needs none.
    gram_compensated: bool = False

    #: Use the JIT-compiled C++/OpenMP host engine (``native/``) for large
    #: Gram assembly and Gram-free matvecs on the CPU backend — the
    #: KeOps-equivalent of the reference (SURVEY.md §2 native list).
    use_native_host_engine: bool = True

    #: Minimum problem size (rows * cols) before the native host engine is
    #: preferred over broadcast XLA evaluation on CPU.
    native_gram_threshold: int = 1 << 20

    #: Mixed-precision conditioning: factor float64 Grams in float32
    #: and recover float64 forward error by preconditioned-CG
    #: iterative refinement (``ops/linalg/refine.py``).  Requires x64.
    solve_refinement: bool = False

    #: Relative-residual target of a refined solve (0 -> ~30 eps of the
    #: high precision, i.e. float64 round-off level).
    refine_tol: float = 0.0

    #: Iteration cap of a refined solve.
    refine_maxiter: int = 400

    #: Relative nugget of the refined (float64) system — eps64-scale,
    #: mirroring the float64 eager escalation path.  The float32 factor
    #: carries its own ~1e-6 nugget; their ratio bounds the
    #: preconditioned spectrum (~1e6 -> O(100) CG iterations).
    refine_target_jitter: float = 1e-12

    #: Relative nugget applied when factoring the float32 copy of a
    #: float64 Gram in refinement mode.
    refine_factor_jitter: float = 1e-6

    #: Host-orchestrated CG (``ops/linalg/pcg.pcg_host``): drive the CG
    #: iteration from the host, calling SEPARATELY jitted device programs
    #: for the Gram matvec and the preconditioner apply, with the O(N)
    #: vector arithmetic in host float64 (float64 CG vectors for a
    #: float32 device program).  Costs two dispatches and O(N) transfers
    #: per iteration.
    host_cg: bool = False

    @property
    def default_dtype(self) -> jnp.dtype:
        return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    def set(self, **kwargs):
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise AttributeError(f"Unknown config key: {key}")
            setattr(self, key, value)


config = _Config()


def use_x64(enable: bool = True) -> None:
    """Enable float64 globally."""
    jax.config.update("jax_enable_x64", enable)
