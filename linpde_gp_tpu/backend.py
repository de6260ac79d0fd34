"""Where each kernel reduction runs, and where compiled programs are kept.

One decision for the whole package.  The routes:

- ``"xla"``: plain ``jax.numpy`` evaluation of the closed form, which XLA
  fuses (``ops/gram.terms_gram`` / ``xla_gram_matvec``) — the GPU route
  (faster end to end on an H100 than a hand-written Pallas/Triton
  streaming kernel, see CHANGES.md) and the CPU route for small problems;
- ``"native"``: the C++/OpenMP host engine (``native/``), reached through
  a host callback, on the CPU above ``config.native_gram_threshold``;
- ``"banded"``: the compact-support schedule of
  ``ops/gram.make_banded_matvec`` (plain ``jax.numpy`` panels).

Supported platforms are ``"cpu"`` and ``"gpu"``; any other raises.
"""

from __future__ import annotations

import os

import jax

from .config import config

PLATFORMS = ("cpu", "gpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def platform(name: str | None = None) -> str:
    """The JAX platform the package computes on (``"cpu"`` or ``"gpu"``)."""
    name = jax.default_backend() if name is None else name
    if name not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: linpde_gp_tpu runs on "
            f"{' and '.join(PLATFORMS)}"
        )
    return name


def route(
    op: str,
    *,
    platform_name: str | None = None,
    terms: bool = True,
    n0: int = 0,
    n1: int = 0,
    compact: bool = False,
) -> str:
    """Route of one kernel reduction.

    ``op``: ``"gram"`` (assemble ``K(X0, X1)``) or ``"matvec"``
    (``K(X0, X1) @ v`` without the Gram).  ``terms``: the kernel has a
    closed-form term spec (``ops/gram.kernel_term_specs``).
    ``n0``/``n1``: row and column counts.  ``compact``: the caller holds
    concrete points of a compactly supported kernel, so the banded
    schedule applies.
    """
    plat = platform(platform_name)
    if op not in ("gram", "matvec"):
        raise ValueError(f"unknown reduction {op!r}")
    if op == "matvec" and terms and compact:
        return "banded"
    if (
        plat == "cpu"
        and terms
        and config.use_native_host_engine
        and n0 * n1 >= config.native_gram_threshold
    ):
        return "native"
    return "xla"


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Keep compiled programs in :func:`compile_cache_dir` and cache every
    program, however small or quick to compile.  Returns the directory."""
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
