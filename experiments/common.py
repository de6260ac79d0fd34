"""Shared experiment harness: precision setup, timing, reporting.

Replaces the reference's ``experiment_utils`` (config/savefig/tueplots)
with a numerics-focused runner: each experiment reports errors vs its
analytic/oracle solution and per-stage wall-clock.
"""

from __future__ import annotations

import json
import os
import sys
import time

# Allow running the scripts from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup(x64: bool | None = None):
    """Float64 unless ``x64=False`` or ``LGT_X64=0``; compiled programs
    cached by ``linpde_gp_tpu.backend.enable_compile_cache``."""
    import jax

    if x64 is None:
        x64 = os.environ.get("LGT_X64", "1") not in ("0", "false", "False")
    jax.config.update("jax_enable_x64", x64)
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu import backend

    backend.enable_compile_cache()

    if not x64:
        lgt.config.set(cholesky_jitter=1e-6)
    return lgt


class StageTimer:
    def __init__(self):
        self.stages = {}
        self._t0 = None
        self._name = None

    def start(self, name):
        self._name = name
        self._t0 = time.perf_counter()

    def stop(self):
        self.stages[self._name] = time.perf_counter() - self._t0

    def __call__(self, name):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.start(name)
            yield
            self.stop()

        return ctx()


def report(name, metrics, timer: StageTimer | None = None, checks=None):
    """Emit the JSON payload and ENFORCE metric tolerances.

    ``checks``: mapping ``metric -> ("<=" | ">=", bound)``.  A breach
    raises, so ``run_all.py`` exits nonzero — regressions in experiment
    accuracy fail loudly instead of silently drifting.
    Skipped when ``LGT_SKIP_CHECKS=1`` (e.g. exploratory runs).
    """
    payload = {"experiment": name, "metrics": metrics}
    if timer is not None:
        payload["wall_clock_s"] = {
            k: round(v, 4) for k, v in timer.stages.items()
        }
    print(json.dumps(payload))
    if checks and os.environ.get("LGT_SKIP_CHECKS") != "1":
        for key, (op, bound) in checks.items():
            val = metrics[key]
            ok = val <= bound if op == "<=" else val >= bound
            if not ok:
                raise AssertionError(
                    f"{name}: metric {key}={val!r} violates {op} {bound!r}"
                )
    return payload
