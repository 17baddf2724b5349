"""Uncertainty-costmap barrier term — reconstruction of the missing
``Uncertainty.h``.

The reference repo ships *call sites only* for this class (it is absent from
the snapshot): included at ``Constraints.h:17`` / ``ilqr_uncertainty_node.h:42``,
constructed at ``ilqr_uncertainty_node.cpp:111-113`` as
``Uncertainty(params, occupancy_msg, grid_map_msg, x_center, y_center,
sigma_x, sigma_y, sigma_theta, 0, 0, nh)`` and queried at
``Constraints.cpp:193`` via ``get_uncertainty_cost(state.col(i))`` which must
return the (value, 4x1 gradient, 4x4 Hessian) bundle scaled by
``w_uncertainty`` (Constraints.cpp:199-200).

Reconstructed semantics (defined once here, mirrored by the float64 oracle in
``oracle/oracle_cilqr.py`` and locked by tests):

* The planner receives the costmap whose OccupancyGrid origin was set to the
  *ego pose at map-build time* (local_costmap.cpp:300) and whose grid-map
  position is (x_center, y_center) = the map_param message values
  (ilqr_uncertainty_node.cpp:140-144; published at local_costmap.cpp:793-799
  with X_POSITION-5 applied at :213).
* ``get_uncertainty_cost(state)``: transform the ego position into the map
  frame, bilinearly sample the propagated ``uncertainty_map`` layer
  (occupancy in [0, 100]), normalize c = u/100, and apply the same
  exponential barrier family used by every other constraint
  (``q1_uncertainty * exp(q2_uncertainty * c)``, Parameters.h:54-55 defaults
  2.5/2.5) with map-gradient first derivatives and the Gauss-Newton outer
  product second derivative — the exact (x, vx, mx) structure of
  ``barrier_function`` (Constraints.cpp:67-78).
* Outside the map the cost is zero (no information -> no barrier).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cilqr_tpu.ops import gridmap
from cilqr_tpu.utils.params import SolverParams


class UncertaintyMap(NamedTuple):
    """Propagated uncertainty costmap + frame metadata.

    values:     (rows, cols) occupancy in [0, 100]
    geom:       grid geometry in the *map frame* (vehicle frame at build time)
    origin_xy:  (2,) global position of the map frame origin (ego at build)
    origin_yaw: () global yaw of the map frame
    """

    values: jax.Array
    geom: gridmap.GridGeom
    origin_xy: jax.Array
    origin_yaw: jax.Array


def make_uncertainty_map(values, center_xy, resolution, origin_xy, origin_yaw, dtype=jnp.float32) -> UncertaintyMap:
    values = jnp.asarray(values, dtype=dtype)
    geom = gridmap.make_geom(center_xy, float(resolution), values.shape[0], values.shape[1], dtype=dtype)
    return UncertaintyMap(
        values,
        geom,
        jnp.asarray(origin_xy, dtype=dtype),
        jnp.asarray(origin_yaw, dtype=dtype),
    )


def uncertainty_sample(p: SolverParams, m: UncertaintyMap, Xs: jax.Array,
                       use_onehot: bool = True):
    """Raw barrier sample at (N, >=2) query states: (e, gx, gy).

    e = q1*exp(q2*c) masked to 0 outside the map (c = occupancy/100);
    (gx, gy) is the global-frame gradient of c (NOT masked — every
    consumer multiplies it by a factor of e).  Used by
    ``uncertainty_cost`` and mirrored by the GPU solve kernel's sampler
    (ops/lm_pallas)."""
    # global -> map frame
    d = Xs[:, :2] - m.origin_xy
    cy, sy = jnp.cos(m.origin_yaw), jnp.sin(m.origin_yaw)
    local = jnp.stack(
        [cy * d[:, 0] + sy * d[:, 1], -sy * d[:, 0] + cy * d[:, 1]], axis=-1
    )

    u, grad_local = gridmap.sample_bilinear_with_grad(m.values, m.geom, local,
                                                      use_onehot=use_onehot)
    inside = gridmap.in_bounds(m.geom, local)

    c = u / 100.0
    grad_c = grad_local / 100.0
    # chain rule back to global frame: d local / d global = R(-yaw); grad_g =
    # R(-yaw)^T grad_l = R(yaw) grad_l
    gx = cy * grad_c[:, 0] - sy * grad_c[:, 1]
    gy = sy * grad_c[:, 0] + cy * grad_c[:, 1]

    e = p.q1_uncertainty * jnp.exp(p.q2_uncertainty * c)
    e = jnp.where(inside, e, 0.0)
    return e, gx, gy



def uncertainty_cost(p: SolverParams, m: UncertaintyMap, X: jax.Array,
                     use_onehot: bool = True):
    """Barrier (x, vx, mx) at each state.

    Args:
      X: (N, 4) or (4,) ego states in the global frame.
      use_onehot: corner fetch strategy (see
        gridmap.sample_bilinear_with_grad).  Pass False when this call is
        vmapped over PER-SCENARIO maps — the batched one-hot would
        materialize a (B, N, cells) tensor (~0.8 GB at B=256 on the default
        152x104 map); the plain gather stays O(B*N).
    Returns:
      (cost (N,), vx (N, 4), mx (N, 4, 4)) — unweighted; the caller applies
      w_uncertainty exactly as Constraints.cpp:199-200 does.
    """
    single = X.ndim == 1
    Xs = jnp.atleast_2d(X)
    N = Xs.shape[0]
    dtype = Xs.dtype
    e, gx, gy = uncertainty_sample(p, m, Xs, use_onehot=use_onehot)
    g = jnp.stack([gx, gy], axis=-1)  # (N, 2)
    vx2 = (p.q2_uncertainty * e)[:, None] * g
    mx2 = (p.q2_uncertainty**2 * e)[:, None, None] * (g[:, :, None] * g[:, None, :])

    vx = jnp.zeros((N, 4), dtype=dtype).at[:, :2].set(vx2)
    mx = jnp.zeros((N, 4, 4), dtype=dtype).at[:, :2, :2].set(mx2)
    if single:
        return e[0], vx[0], mx[0]
    return e, vx, mx
