r"""Native (C++/OpenMP) kernel-reduction engine — the KeOps equivalent
for the host/CPU path.

The reference delegates large kernel-matrix work to ``pykeops`` — a C++
meta-programming library that JIT-compiles each symbolic kernel formula
to an OpenMP (or CUDA) map-reduce (consumption sites listed in
SURVEY.md §2, "Native / non-Python components"; e.g. reference
``covfuncs/_tensor_product.py:111-130``, ``functions/_polynomial.py:79-86``).

On the GPU that role is played by the fused XLA evaluation of
``ops/gram.py``.  On the host (float64
verification, oracles, CPU-only deployments) this module provides the
same architecture as KeOps itself:

1. a kernel formula — the ``(scale, terms)`` sum-of-products spec shared
   with the device path (``ops/gram.kernel_term_specs``) — is
   **code-generated to specialized C++** (polynomial coefficients become
   literals, Horner chains and factor products are fully unrolled),
2. compiled once per formula with ``g++ -O3 -fopenmp`` into a shared
   library cached on disk keyed by a content hash,
3. loaded via ``ctypes`` and exposed as two reductions:
   - ``gram``   : materialize ``K(X0, X1)``  (O(n0*n1) memory), and
   - ``matvec`` : ``K(X0, X1) @ V`` without materializing ``K``
     (O(n0+n1) memory — KeOps' lazy ``LazyTensor`` reduction mode).

Everything is float64 end-to-end: this engine is the high-precision
host-side oracle and the CPU production path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_LOCK = threading.Lock()
_ENGINES: dict = {}
_GXX = shutil.which("g++")


def available() -> bool:
    """True if a host C++ toolchain is present."""
    return _GXX is not None


def _cache_dir() -> str:
    """Per-user cache directory, created 0700 and ownership-verified.

    A world-shared predictable path would let another local user plant a
    malicious ``.so`` that ``ctypes.CDLL`` silently loads; keying the
    default on the uid and refusing dirs we don't own closes that hole
    (and keeps ``-march=native`` artifacts machine/user-local).
    """
    root = os.environ.get("LGT_NATIVE_CACHE")
    if root is None:
        uid = os.getuid() if hasattr(os, "getuid") else "na"
        root = os.path.join(tempfile.gettempdir(), f"lgt_native_cache_{uid}")
    os.makedirs(root, mode=0o700, exist_ok=True)
    st = os.stat(root)
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        raise PermissionError(
            f"native cache dir {root!r} is owned by uid {st.st_uid}, not us; "
            "set LGT_NATIVE_CACHE to a directory you own"
        )
    return root


def _fmt(x: float) -> str:
    """Full-precision C++ double literal."""
    s = repr(float(x))
    if "e" not in s and "." not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return s


def _factor_code(name: str, kind: str, s: float, poly, parity: int,
                 pref: float, dvar: str) -> str:
    """Emit C++ statements computing one univariate factor value.

    Mirrors ``ops/transforms/univariate.UnivariateFactor.__call__``:
    matern: ``pref * P(s*|d|) * exp(-s*|d|) [* sign(d)]``;
    expquad: ``pref * P(s*d) * exp(-(s*d)^2)``.
    """
    lines = []
    if kind in ("matern", "wendland"):
        lines.append(f"      const double t_{name} = {_fmt(s)} * std::fabs({dvar});")
        tv = f"t_{name}"
    elif kind == "expquad":
        lines.append(f"      const double t_{name} = {_fmt(s)} * {dvar};")
        tv = f"t_{name}"
    else:  # pragma: no cover - spec invariant
        raise ValueError(f"unknown factor kind: {kind!r}")
    lines.append(f"      double p_{name} = {_fmt(poly[-1])};")
    for c in reversed(poly[:-1]):
        lines.append(f"      p_{name} = p_{name} * {tv} + {_fmt(c)};")
    if kind == "matern":
        expr = f"{_fmt(pref)} * p_{name} * std::exp(-{tv})"
        if parity:
            expr += f" * sgn({dvar})"
    elif kind == "wendland":
        # Compact support: polynomial inside [0, 1], zero outside.
        expr = f"{_fmt(pref)} * ({tv} <= 1.0 ? p_{name} : 0.0)"
        if parity:
            expr += f" * sgn({dvar})"
    else:
        expr = f"{_fmt(pref)} * p_{name} * std::exp(-({tv} * {tv}))"
    lines.append(f"      const double f_{name} = {expr};")
    return "\n".join(lines)


def _generate_source(scale: float, terms: tuple, dim: int) -> str:
    """Generate the specialized C++ translation unit for one formula."""
    # Deduplicate (coordinate, factor-spec) pairs across terms, exactly
    # like the factor memoization in the sum-of-products kernels.
    factor_vars: dict = {}
    factor_blocks: list[str] = []
    term_exprs: list[str] = []
    for coeff, factors in terms:
        if len(factors) != dim:  # pragma: no cover - spec invariant
            raise ValueError("inconsistent factor arity across terms")
        prod = [_fmt(coeff)]
        for i, spec in enumerate(factors):
            key = (i, spec)
            if key not in factor_vars:
                name = f"{len(factor_vars)}"
                factor_vars[key] = name
                factor_blocks.append(_factor_code(name, *spec, dvar=f"d{i}"))
            prod.append(f"f_{factor_vars[key]}")
        term_exprs.append(" * ".join(prod))

    diffs = "\n".join(
        f"      const double d{i} = xi[{i}] - xj[{i}];" for i in range(dim)
    )
    body = "\n".join(factor_blocks)
    acc = "\n        + ".join(term_exprs)

    return f"""// Auto-generated by linpde_gp_tpu.native.engine — do not edit.
// Specialized pairwise kernel reduction (KeOps-equivalent host engine).
#include <cmath>
#include <cstdint>

namespace {{
inline double sgn(double d) {{ return (double)((d > 0.0) - (d < 0.0)); }}

inline double kpair(const double* __restrict xi, const double* __restrict xj) {{
{diffs}
{body}
      return {_fmt(scale)} * ({acc});
}}
}}  // namespace

extern "C" {{

// out[i, j] = k(x0[i], x1[j]); row-major (n0, n1).
void lgt_gram(const double* __restrict x0, const double* __restrict x1,
              int64_t n0, int64_t n1, double* __restrict out) {{
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {{
    const double* xi = x0 + i * {dim};
    double* row = out + i * n1;
    for (int64_t j = 0; j < n1; ++j) {{
      row[j] = kpair(xi, x1 + j * {dim});
    }}
  }}
}}

// out[i, r] = sum_j k(x0[i], x1[j]) * v[j, r]  — Gram-free map-reduce.
void lgt_matvec(const double* __restrict x0, const double* __restrict x1,
                int64_t n0, int64_t n1, int64_t nr,
                const double* __restrict v, double* __restrict out) {{
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {{
    const double* xi = x0 + i * {dim};
    double* acc = out + i * nr;
    for (int64_t r = 0; r < nr; ++r) acc[r] = 0.0;
    for (int64_t j = 0; j < n1; ++j) {{
      const double kij = kpair(xi, x1 + j * {dim});
      const double* vj = v + j * nr;
      for (int64_t r = 0; r < nr; ++r) acc[r] += kij * vj[r];
    }}
  }}
}}

}}  // extern "C"
"""


def _compile(source: str) -> str:
    """Compile ``source`` into a cached shared library; return its path."""
    key = hashlib.sha256(source.encode()).hexdigest()[:24]
    cache = _cache_dir()
    lib_path = os.path.join(cache, f"lgt_{key}.so")
    if os.path.exists(lib_path):
        st = os.stat(lib_path)
        if not hasattr(os, "getuid") or st.st_uid == os.getuid():
            return lib_path
        os.unlink(lib_path)  # foreign artifact: rebuild, never load
    src_path = os.path.join(cache, f"lgt_{key}.cpp")
    with open(src_path, "w") as fh:
        fh.write(source)
    tmp_path = lib_path + f".tmp{os.getpid()}"
    cmd = [
        _GXX, "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
        "-march=native", src_path, "-o", tmp_path,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp_path, lib_path)  # atomic vs concurrent builders
    return lib_path


_PTR = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


class NativeGramEngine:
    """A compiled, formula-specialized pairwise-kernel reduction."""

    def __init__(self, scale: float, terms: tuple):
        self.dim = len(terms[0][1])
        source = _generate_source(float(scale), terms, self.dim)
        self._lib = ctypes.CDLL(_compile(source))
        self._lib.lgt_gram.argtypes = [
            _PTR, _PTR, ctypes.c_int64, ctypes.c_int64, _PTR,
        ]
        self._lib.lgt_gram.restype = None
        self._lib.lgt_matvec.argtypes = [
            _PTR, _PTR, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _PTR, _PTR,
        ]
        self._lib.lgt_matvec.restype = None

    def _points(self, X) -> np.ndarray:
        X = np.ascontiguousarray(X, dtype=np.float64)
        X = X.reshape(-1, self.dim) if X.ndim != 1 else X[:, None]
        if X.shape[1] != self.dim:  # pragma: no cover - caller contract
            raise ValueError(f"expected point dim {self.dim}, got {X.shape[1]}")
        return X

    def gram(self, X0, X1) -> np.ndarray:
        x0, x1 = self._points(X0), self._points(X1)
        out = np.empty((x0.shape[0], x1.shape[0]), dtype=np.float64)
        self._lib.lgt_gram(x0, x1, x0.shape[0], x1.shape[0], out)
        return out

    def matvec(self, X0, X1, v) -> np.ndarray:
        x0, x1 = self._points(X0), self._points(X1)
        v = np.ascontiguousarray(v, dtype=np.float64)
        vector = v.ndim == 1
        v2 = v[:, None] if vector else v
        out = np.empty((x0.shape[0], v2.shape[1]), dtype=np.float64)
        self._lib.lgt_matvec(x0, x1, x0.shape[0], x1.shape[0], v2.shape[1], v2, out)
        return out[:, 0] if vector else out


def engine_for_spec(scale: float, terms: tuple) -> NativeGramEngine | None:
    """Build (or fetch from cache) the engine for a term spec."""
    if not available():
        return None
    key = (float(scale), terms)
    with _LOCK:
        eng = _ENGINES.get(key)
        if eng is None:
            try:
                eng = NativeGramEngine(scale, terms)
            except (subprocess.CalledProcessError, OSError):
                return None
            _ENGINES[key] = eng
    return eng


def engine_for(kernel) -> NativeGramEngine | None:
    """Engine for a kernel in the sum-of-products closed-form family."""
    from ..ops.gram import kernel_term_specs

    spec = kernel_term_specs(kernel)
    if spec is None:
        return None
    return engine_for_spec(*spec)
