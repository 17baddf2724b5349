"""DBSCAN point clustering — a *working* JAX replacement.

The reference ships a DBSCAN for lidar-obstacle clustering that does not
compile and is never called (``map_engine/include/DBSCAN.cpp``: undefined
``squareDistanceVect`` :29, nonexistent member ``.xn`` :105, syntax error
``j++DBSCAN`` :109 — SURVEY.md §0.4).  This module provides the capability
it intended: density clustering of 2-D points, implemented with fixed-shape
masked label propagation (no data-dependent frontier queues) so it jits and
vmaps.

Algorithm: core points = those with >= min_points neighbors within eps
(self included, as in canonical DBSCAN); labels propagate through the
core-to-core adjacency via min-label iteration (converges in <= n rounds,
run as lax.while_loop on change detection); border points adopt the label of
any core neighbor; noise = -1.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(3,))
def dbscan(points: jax.Array, eps: float, mask=None, min_points: int = 3):
    """Cluster (N, 2) points.

    Args:
      points: (N, 2); mask: optional (N,) validity (padding lanes excluded).
      eps: neighborhood radius; min_points: density threshold (incl. self).
    Returns:
      labels (N,) int32: cluster ids are the minimum point index in the
      cluster; -1 for noise/invalid.
    """
    n = points.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    else:
        mask = mask.astype(bool)

    d2 = jnp.sum((points[:, None, :] - points[None, :, :]) ** 2, axis=-1)
    adj = (d2 <= eps * eps) & mask[:, None] & mask[None, :]
    degree = jnp.sum(adj, axis=1)
    core = (degree >= min_points) & mask

    core_adj = adj & core[:, None] & core[None, :]
    idx = jnp.arange(n, dtype=jnp.int32)
    labels0 = jnp.where(core, idx, jnp.iinfo(jnp.int32).max)

    def cond(state):
        labels, changed = state
        return changed

    def body(state):
        labels, _ = state
        # min label over core neighbors (label propagation on the core graph)
        neigh = jnp.where(core_adj, labels[None, :], jnp.iinfo(jnp.int32).max)
        new = jnp.minimum(labels, jnp.min(neigh, axis=1))
        return (new, jnp.any(new != labels))

    labels, _ = jax.lax.while_loop(cond, body, (labels0, jnp.asarray(True)))

    # border points: adopt the min core-neighbor label
    border_neigh = jnp.where(adj & core[None, :], labels[None, :], jnp.iinfo(jnp.int32).max)
    border_label = jnp.min(border_neigh, axis=1)
    out = jnp.where(core, labels, border_label)
    out = jnp.where(out == jnp.iinfo(jnp.int32).max, -1, out)
    return jnp.where(mask, out, -1).astype(jnp.int32)
