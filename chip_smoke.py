"""Smoke run of GP conditioning on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 0-3
    python chip_smoke.py --four-cards  # four cards: the mesh path only

Phases (one card):

0. device: platform, kind, count, JAX version, card name and power limit;
1. the Gram-free matvec as routed for the card against the plain float64
   reference at N=1e5 (heat ``H k H*`` terms, r in {1, 256}, float64,
   float32 and compensated float32), and the banded Wendland matvec;
2. dense conditioning through ``GaussianProcess.condition_on_observations``
   (``experiments/heat_1d.py`` with 8,192 PDE observations + IC/BC);
3. gram-free conditioning through ``IterativeGPRegressor`` at N=1e5 with
   192 IC/BC anchors, against the analytic heat solution.

With ``--four-cards`` only the mesh path runs: ``DistributedConditioner``
at N=32,768 against one card's Cholesky, and
``DistributedIterativeGPRegressor`` at N=1e5 against
``IterativeGPRegressor`` on one card.

Every phase prints one line; any failure raises and exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``.  Needs the repository
checkout beside it and a GPU that JAX can see.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N = 100_000
N_DENSE = 32_768


def _say(phase, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {parts}", flush=True)


def _gate(name, value, bound):
    if not value <= bound:
        raise AssertionError(f"{name}={value!r} exceeds {bound!r}")


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _heat_kernels():
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.ops.transforms import apply_operator_to_kernel

    spatial = lgt.domains.asdomain([-1.0, 1.0])
    ibvp = lgt.problems.HeatEquationDirichletProblem(
        t0=0.0,
        T=5.0,
        spatial_domain=spatial,
        alpha=0.1,
        initial_values=lgt.functions.TruncatedSineSeries(spatial, coefficients=[1.0]),
    )
    prior = lgt.GaussianProcess(
        lgt.functions.Zero((2,)),
        1.0 * lgt.kernels.TensorProduct(
            lgt.kernels.Matern((), nu=1.5, lengthscales=2.5),
            lgt.kernels.Matern((), nu=2.5, lengthscales=2.0),
        ),
    )
    H = ibvp.pde.diffop
    k_hh = apply_operator_to_kernel(
        H, apply_operator_to_kernel(H, prior.cov, argnum=1), argnum=0
    )
    return ibvp, prior, H, k_hh


def _space_time_points(rng, n):
    return np.stack([rng.uniform(0.0, 5.0, n), rng.uniform(-1.0, 1.0, n)], axis=-1)


def _reference(terms, X0, X1, V, rows=512):
    """Plain row-blocked float64 ``(K @ V, |K| @ |V|)`` with ``HIGHEST``
    on every dot."""
    import jax
    import jax.numpy as jnp

    from linpde_gp_tpu.ops.gram import terms_gram

    hi = jax.lax.Precision.HIGHEST
    n0 = X0.shape[0]
    nb = -(-n0 // rows)
    X0p = jnp.zeros((nb * rows, X0.shape[1]), jnp.float64).at[:n0].set(X0)

    def block(x0):
        G = terms_gram(terms, x0, X1, compensated=False)
        return jnp.matmul(G, V, precision=hi), jnp.matmul(jnp.abs(G), jnp.abs(V), precision=hi)

    out, bound = jax.lax.map(block, X0p.reshape(nb, rows, -1))
    return out.reshape(nb * rows, -1)[:n0], bound.reshape(nb * rows, -1)[:n0]


def phase_device(four_cards):
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {dev.platform!r}); nothing was run"
        )
    want = 4 if four_cards else 1
    if len(devices) < want:
        raise SystemExit(f"chip_smoke: {want} GPUs needed, JAX sees {len(devices)}")
    # nvidia-smi in a child process that does not import JAX.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    _say("device", platform=dev.platform, kind=repr(dev.device_kind),
         count=len(devices), jax=jax.__version__)
    for line in smi:
        print(line, flush=True)
    return dev, smi[0]


def phase_kernels(card):
    import jax
    import jax.numpy as jnp

    from linpde_gp_tpu import backend
    from linpde_gp_tpu.ops.gram import gram_matvec, kernel_term_specs

    _, _, _, k_hh = _heat_kernels()
    spec = kernel_term_specs(k_hh)
    rng = np.random.default_rng(SEED)
    X = _space_time_points(rng, N)
    route = backend.route("matvec", n0=N, n1=N)
    # Error relative to max_i (|K||v|)_i.  float64: round-off of the
    # closed form.  float32: the entries' ~1e-6 evaluation error plus the
    # float32 row sums.  Compensated float32: the entries are exact to
    # ~1e-13, but XLA's reduction (r=1) and GEMM (r=256) accumulate the
    # 1e5 products in float32 and the result is float32, so float32
    # accumulation rounding (~eps32 * sqrt(1e5) ~ 2e-5 at worst), not the
    # entries, sets the floor; 1e-9 would need a float64 accumulator.
    bounds = {"f64": 1e-10, "f32": 1e-4, "f32c": 1e-5}
    for name, dtype, comp in (
        ("f64", np.float64, False),
        ("f32", np.float32, False),
        ("f32c", np.float32, True),
    ):
        x = jnp.asarray(X.astype(dtype))
        x64 = x.astype(jnp.float64)
        for r in (1, 256):
            V = rng.standard_normal((N, r)).astype(dtype)
            v = jnp.asarray(V[:, 0] if r == 1 else V)
            fn = jax.jit(lambda a, w, c=comp: gram_matvec(spec, a, a, w, compensated=c))
            if name == "f64" and r == 1:
                mem = fn.lower(x, v).compile().memory_analysis()
                print(f"[kernels] matvec memory_analysis: {mem}", flush=True)
            out, t_first = _timed(fn, x, v)
            out, t = _timed(fn, x, v)
            ref, bound = jax.jit(_reference, static_argnums=0)(
                spec[1], x64, x64, jnp.asarray(V, jnp.float64)
            )
            out = np.asarray(out, np.float64).reshape(N, r)
            err = float(np.max(np.abs(out - spec[0] * np.asarray(ref)))) / float(
                spec[0] * np.max(np.asarray(bound))
            )
            _say("kernels", route=route, dtype=name, r=r, n=N, rel_err=f"{err:.3e}",
                 bound=bounds[name], first_s=f"{t_first:.3f}", s=f"{t:.4f}", card=repr(card))
            _gate(f"matvec {name} r={r} error", err, bounds[name])

    # Banded compact-support matvec (Wendland) at N=1e5.
    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.ops.gram import make_banded_matvec

    kw = 2.0 * lgt.kernels.WendlandCovarianceFunction((), k=2, lengthscales=0.02)
    wspec = kernel_term_specs(kw)
    Xw = rng.uniform(0.0, 1.0, (N, 1))
    mv = make_banded_matvec(wspec, Xw, Xw)
    vw = jnp.asarray(rng.standard_normal(N))
    fn = jax.jit(mv)
    mem = fn.lower(vw).compile().memory_analysis()
    out, t_first = _timed(fn, vw)
    out, t = _timed(fn, vw)
    xw = jnp.asarray(Xw)
    ref, bound = jax.jit(_reference, static_argnums=0)(wspec[1], xw, xw, vw[:, None])
    err = float(np.max(np.abs(np.asarray(out) - wspec[0] * np.asarray(ref)[:, 0]))) / float(
        wspec[0] * np.max(np.asarray(bound))
    )
    _say("kernels", route="banded", dtype="f64", r=1, n=N, band_tiles=mv.band_tiles,
         total_tiles=mv.total_tiles, rel_err=f"{err:.3e}", bound=1e-10,
         first_s=f"{t_first:.3f}", s=f"{t:.4f}", card=repr(card))
    print(f"[kernels] banded memory_analysis: {mem}", flush=True)
    _gate("banded matvec error", err, 1e-10)


def phase_dense(card):
    sys.path.insert(0, os.path.join(ROOT, "experiments"))
    import heat_1d

    t0 = time.perf_counter()
    payload = heat_1d.main(n_pde=(128, 64), n_ic=5, n_bc=50)  # raises on a failed check
    m = payload["metrics"]
    _say("dense", n_obs=m["n_obs"], mae=f"{m['mae']:.3e}", coverage=f"{m['coverage']:.4f}",
         s=f"{time.perf_counter() - t0:.2f}", card=repr(card))


def heat_solve_problem(rng, n, n_ic=96, n_bc=48, anchors=True):
    import jax.numpy as jnp

    from linpde_gp_tpu.ops.gram import kernel_term_specs

    ibvp, prior, H, k_hh = _heat_kernels()
    X = _space_time_points(rng, n)
    scale, terms = kernel_term_specs(k_hh)
    diag = scale * sum(
        float(c) * float(np.prod([0.0 if f[3] else f[4] * f[2][0] for f in fs]))
        for c, fs in terms
    )
    out = dict(ibvp=ibvp, prior=prior, H=H, X=X, Y=np.zeros(n), noise=1e-3 * diag)
    if anchors:
        X_ic = np.stack([np.zeros(n_ic), np.linspace(-1.0, 1.0, n_ic)], axis=-1)
        t_bc = np.linspace(0.0, 5.0, n_bc)
        X_bc = np.concatenate([
            np.stack([t_bc, np.full(n_bc, -1.0)], axis=-1),
            np.stack([t_bc, np.full(n_bc, 1.0)], axis=-1),
        ])
        X_a = np.concatenate([X_ic, X_bc])
        out.update(X_anchor=X_a, Y_anchor=np.asarray(ibvp.solution(jnp.asarray(X_a))))
    return out


def phase_gram_free(card):
    import jax
    import jax.numpy as jnp

    from linpde_gp_tpu.models.iterative import IterativeGPRegressor

    rng = np.random.default_rng(SEED)
    p = heat_solve_problem(rng, N)
    tol = 1e-5
    t0 = time.perf_counter()
    reg = IterativeGPRegressor(
        p["prior"], p["X"], p["Y"], L=p["H"], noise_variance=p["noise"],
        tol=tol, maxiter=512, precond_rank=min(4096, N // 4),
        anchor_X=p["X_anchor"], anchor_Y=p["Y_anchor"], anchor_noise=1e-12,
    )
    jax.block_until_ready(reg.representer_weights)
    t_solve = time.perf_counter() - t0
    iters, relres = reg.solve_info
    _say("gram_free", n=N, anchors=p["X_anchor"].shape[0], rank=reg.precond_rank, iters=iters,
         relres=f"{relres:.3e}", solve_s=f"{t_solve:.2f}", card=repr(card))
    _gate("CG relative residual", relres, tol)

    nq = 8192
    Xq = _space_time_points(rng, nq)
    mean, t_mean = _timed(reg.mean, jnp.asarray(Xq))
    truth = np.asarray(p["ibvp"].solution(jnp.asarray(Xq))).reshape(-1)
    rmse = float(np.sqrt(np.mean((np.asarray(mean) - truth) ** 2)))
    var, t_var = _timed(reg.var, jnp.asarray(Xq[:256]))
    var = np.asarray(var)
    _say("gram_free", nq=nq, rmse=f"{rmse:.3e}", mean_s=f"{t_mean:.2f}",
         var_n=256, var_min=f"{var.min():.3e}", var_s=f"{t_var:.2f}", card=repr(card))
    _gate("posterior-mean RMSE vs analytic", rmse, 5e-4)
    if not (np.all(np.isfinite(var)) and np.all(var >= 0.0)):
        raise AssertionError("posterior variance is not finite and non-negative")


def phase_four_cards(card):
    from linpde_gp_tpu.parallel import make_mesh

    mesh = make_mesh(4)
    rng = np.random.default_rng(SEED)
    _four_cards_dense(mesh, rng, card)
    _four_cards_gram_free(mesh, rng, card)


def _four_cards_dense(mesh, rng, card):
    import jax
    import jax.numpy as jnp

    import linpde_gp_tpu as lgt
    from linpde_gp_tpu.ops.gram import gram_matrix
    from linpde_gp_tpu.parallel import DistributedConditioner

    n = N_DENSE
    m1 = lgt.kernels.Matern((), nu=2.5, lengthscales=0.5)
    k = lgt.kernels.TensorProduct(m1, m1)
    X = rng.uniform(-1.0, 1.0, (n, 2))
    Y = rng.standard_normal(n)
    noise = 1e-2
    t0 = time.perf_counter()
    w = np.asarray(jax.block_until_ready(
        DistributedConditioner(mesh=mesh, block_size=128).condition(
            k, X, Y, noise_variance=noise, jitter=0.0
        )
    ))
    t_dist = time.perf_counter() - t0

    @jax.jit
    def single(x, y):
        # One program, so the (n, n) Gram is one fused buffer on one card.
        G = gram_matrix(k, x) + noise * jnp.eye(n, dtype=x.dtype)
        return jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(G), True), y)

    t0 = time.perf_counter()
    w_ref = np.asarray(jax.block_until_ready(single(jnp.asarray(X), jnp.asarray(Y))))
    t_single = time.perf_counter() - t0
    err = float(np.max(np.abs(w - w_ref)) / np.max(np.abs(w_ref)))
    _say("four_cards", path="DistributedConditioner", n=n, mesh=dict(mesh.shape),
         block=128, rel_err=f"{err:.3e}", bound=1e-8, mesh_s=f"{t_dist:.2f}",
         single_s=f"{t_single:.2f}", card=repr(card))
    _gate("distributed vs single-card Cholesky solve", err, 1e-8)


def _four_cards_gram_free(mesh, rng, card):
    import jax
    import jax.numpy as jnp

    from linpde_gp_tpu.models.iterative import IterativeGPRegressor
    from linpde_gp_tpu.parallel import DistributedIterativeGPRegressor

    p = heat_solve_problem(rng, N, anchors=False)
    Y = np.sin(p["X"][:, 0]) * p["X"][:, 1]
    kw = dict(L=p["H"], noise_variance=p["noise"], tol=1e-8, maxiter=1024,
              precond_rank=min(4096, N // 4))
    Xq = _space_time_points(rng, 8192)
    t0 = time.perf_counter()
    dist = DistributedIterativeGPRegressor(p["prior"], p["X"], Y, mesh=mesh, **kw)
    m_dist = np.asarray(jax.block_until_ready(dist.mean(jnp.asarray(Xq))))
    t_dist = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = IterativeGPRegressor(p["prior"], p["X"], Y, **kw)
    m_single = np.asarray(jax.block_until_ready(single.mean(jnp.asarray(Xq))))
    t_single = time.perf_counter() - t0
    err = float(np.max(np.abs(m_dist - m_single)) / np.max(np.abs(m_single)))
    _say("four_cards", path="DistributedIterativeGPRegressor", n=N, mesh=dict(mesh.shape),
         iters=dist.solve_info[0], single_iters=single.solve_info[0],
         rel_err=f"{err:.3e}", bound=1e-6, mesh_s=f"{t_dist:.2f}",
         single_s=f"{t_single:.2f}", card=repr(card))
    _gate("mesh vs single-card posterior mean", err, 1e-6)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card mesh path")
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "linpde_gp_tpu")):
        raise SystemExit("chip_smoke: the linpde_gp_tpu package is not beside this script")
    sys.path.insert(0, ROOT)

    import jax

    jax.config.update("jax_enable_x64", True)
    from linpde_gp_tpu import backend

    backend.enable_compile_cache()
    dev, card = phase_device(args.four_cards)
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_kernels(card)
        phase_dense(card)
        phase_gram_free(card)
    result = {
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
