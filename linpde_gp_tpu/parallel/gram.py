"""Mesh-sharded Gram assembly.

The ``N x N`` operator-transformed Gram is sharded over a 2-D device
mesh: row points are split over the ``rows`` axis, column points over
``cols``, and every device evaluates exactly its own tile with the local
closed-form kernel (``ops/gram.terms_gram``) — zero communication
(SURVEY.md §2 "parallelism" checklist).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.gram import kernel_term_specs, terms_gram


def sharded_gram(kernel, X0, X1=None, *, mesh: Mesh) -> jnp.ndarray:
    """Assemble ``k(X0, X1)`` with output sharded ``(rows, cols)`` over
    the mesh.  Falls back to replicated dense assembly for kernels outside
    the closed-form family."""
    X0 = jnp.asarray(X0).reshape((-1,) + kernel.input_shape)
    X1 = X0 if X1 is None else jnp.asarray(X1).reshape((-1,) + kernel.input_shape)
    spec = kernel_term_specs(kernel)
    if spec is None:
        return kernel.matrix(X0, X1)
    scale, terms = spec
    x0 = X0.reshape(X0.shape[0], -1)
    x1 = X1.reshape(X1.shape[0], -1)

    # 2-D meshes tile both point sets; 1-D meshes shard rows only.
    names = mesh.axis_names
    rows = names[0]
    cols = names[1] if len(names) > 1 else None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(rows, None), P(cols, None)),
        out_specs=P(rows, cols),
    )
    def assemble(x0_local, x1_local):
        return scale * terms_gram(terms, x0_local, x1_local, compensated=False)

    return assemble(x0, x1)
