"""Host-side native (C++/OpenMP) kernel reductions — KeOps equivalent.

On the GPU the reductions run on the device (``ops/gram``); this
package covers the role the reference's ``pykeops`` dependency plays on
the host: JIT-specialized C++ map-reduce over kernel formulas.
"""

from .engine import NativeGramEngine, available, engine_for, engine_for_spec

__all__ = [
    "NativeGramEngine",
    "available",
    "engine_for",
    "engine_for_spec",
]
