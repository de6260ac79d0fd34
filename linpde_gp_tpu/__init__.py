"""linpde_gp_tpu — a physics-informed Gaussian-process inference
framework in JAX, run on the CPU and on NVIDIA GPUs.

A from-scratch JAX/XLA re-design with the capabilities of
``marvinpfoertner/linpde-gp`` (arXiv:2212.12474): linear PDEs (and general
linear-operator inverse problems) solved by conditioning a GP prior on
observations of linear functionals — point evaluations, derivatives,
boundary values, integrals, and Galerkin/FEM projections — with
closed-form posterior mean and covariance.

Top-level layout:

- ``ops``       kernels, operator DSL, functionals, cross-covariances,
                structured linalg, transformation rule engine, Gram
                assembly and streaming matvecs.
- ``backend``   the one routing decision (CPU / GPU) and the compile
                cache.
- ``models``    functions, domains, random variables/processes, the GP
                conditioning engine, PDE problem definitions.
- ``parallel``  device-mesh sharding: distributed Gram assembly, blocked
                Cholesky, sharded posterior evaluation.
- ``utils``     shapes, plotting.
"""

from . import config as _config_module
from .config import config, use_x64

from . import models, ops
from .models import (
    ConditionalGaussianProcess,
    Constant,
    DeterministicProcess,
    GaussianProcess,
    Normal,
    asrandvar,
    domains,
    problems,
    randvars,
)
from .models import functions
from .ops import crosscov, diffops, functionals, kernels, linalg, transforms

# Reference-compatible aliases (the reference exposes ``linfuncops`` /
# ``linfunctls`` / ``randprocs.covfuncs``; users migrating from it get the
# same names).
linfuncops = diffops
linfunctls = functionals


class _RandProcsNamespace:
    """Namespace mirroring ``linpde_gp.randprocs``."""

    covfuncs = kernels
    crosscov = crosscov

    from .models.gp import (  # noqa: PLC0415
        ConditionalGaussianProcess,
        GaussianProcess,
    )
    from .models.iterative import IterativeGPRegressor  # noqa: PLC0415
    from .models.parametric import ParametricGaussianProcess  # noqa: PLC0415
    from .models.randprocs import DeterministicProcess, asrandproc  # noqa: PLC0415


randprocs = _RandProcsNamespace

__version__ = "0.1.0"

__all__ = [
    "config",
    "use_x64",
    "models",
    "ops",
    "functions",
    "domains",
    "problems",
    "randvars",
    "kernels",
    "diffops",
    "functionals",
    "linfuncops",
    "linfunctls",
    "crosscov",
    "linalg",
    "transforms",
    "randprocs",
    "GaussianProcess",
    "ConditionalGaussianProcess",
    "DeterministicProcess",
    "Normal",
    "Constant",
    "asrandvar",
]
