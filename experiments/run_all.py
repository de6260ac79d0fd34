"""Run every experiment and print a consolidated Markdown report."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import poisson_1d
    import poisson_2d
    import heat_1d
    import poisson_fem
    import poisson_1d_inverse_rhs
    import cpu_thermal_1d
    import cpu_thermal_2d

    runs = [
        ("poisson_1d (n=3, paper config)", lambda: poisson_1d.main(3)),
        ("poisson_1d (n=20)", lambda: poisson_1d.main(20)),
        ("poisson_2d", poisson_2d.main),
        ("heat_1d", heat_1d.main),
        ("poisson_fem", poisson_fem.main),
        ("poisson_1d_inverse_rhs", poisson_1d_inverse_rhs.main),
        ("cpu_thermal_1d", cpu_thermal_1d.main),
        ("cpu_thermal_1d_joint", cpu_thermal_1d.main_joint),
        ("cpu_thermal_2d", cpu_thermal_2d.main),
    ]

    results = []
    for name, fn in runs:
        buf = io.StringIO()
        with redirect_stdout(buf):
            payload = fn()
        results.append((name, payload))
        print(f"done: {name}", flush=True)

    out = ["# Experiment results", ""]
    import jax

    out.append(
        f"Backend: `{jax.default_backend()}`, "
        f"x64: `{jax.config.jax_enable_x64}`."
    )
    out.append("")
    for name, payload in results:
        out.append(f"## {name}")
        out.append("```json")
        out.append(json.dumps(payload, indent=2))
        out.append("```")
        out.append("")
    print("\n".join(out))


if __name__ == "__main__":
    main()
