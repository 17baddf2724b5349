"""Rotated-ellipse obstacle safety sets with exponential barriers.

Reference semantics: ``CILQR/src/ilqr/include/ilqr/Obstacle.cpp``.

Batched layout: all obstacles live in one padded pytree and are evaluated
for every (obstacle, timestep) pair in a single fused broadcast — replacing
the reference's per-obstacle object loop (Constraints.cpp:180-187).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cilqr_tpu.utils.params import SolverParams


class Obstacles(NamedTuple):
    """Padded per-timestep obstacle predictions.

    dims:  (M, N, 2)  [length, width] per timestep (Obstacle.h `dimension`)
    pos:   (M, N, 4)  [x, y, v, theta] per timestep (`relative_pos_array`)
    mask:  (M,)       1.0 for real obstacles, 0.0 for padding
    """

    dims: jax.Array
    pos: jax.Array
    mask: jax.Array


def make_static_obstacles(
    p: SolverParams, centers, sizes, yaws, speeds=None, dtype=jnp.float32
) -> Obstacles:
    """Build a padded ``Obstacles`` pytree from static obstacle descriptors.

    Mirrors the planner node's (commented-out but message-defined) conversion
    of ``VehicleInfoArray`` into per-horizon obstacle tracks
    (ilqr_uncertainty_node.cpp:151-190): constant pose over the horizon.
    """
    centers = jnp.asarray(centers, dtype=dtype).reshape(-1, 2)
    sizes = jnp.asarray(sizes, dtype=dtype).reshape(-1, 2)
    yaws = jnp.asarray(yaws, dtype=dtype).reshape(-1)
    m = centers.shape[0]
    if speeds is None:
        speeds = jnp.zeros((m,), dtype=dtype)
    else:
        speeds = jnp.asarray(speeds, dtype=dtype).reshape(-1)
    M, N = p.max_obstacles, p.horizon
    if m > M:
        raise ValueError(f"{m} obstacles > max_obstacles={M}")

    dims = jnp.zeros((M, N, 2), dtype=dtype)
    pos = jnp.zeros((M, N, 4), dtype=dtype)
    # Padding obstacles sit far away so their (masked) barrier also underflows.
    pos = pos.at[:, :, 0].set(1e6)
    mask = jnp.zeros((M,), dtype=dtype)

    dims = dims.at[:m].set(jnp.broadcast_to(sizes[:, None, :], (m, N, 2)))
    track = jnp.stack(
        [centers[:, 0], centers[:, 1], speeds, yaws], axis=-1
    )  # (m, 4)
    pos = pos.at[:m].set(jnp.broadcast_to(track[:, None, :], (m, N, 4)))
    mask = mask.at[:m].set(1.0)
    return Obstacles(dims, pos, mask)


def obstacle_cost_derivs(p: SolverParams, obs: Obstacles, X: jax.Array):
    """Summed obstacle barrier gradient/Hessian over all obstacles.

    Args:
      X: (N, 4) states for timesteps 0..N-1.
    Returns:
      (vx (N,4), mx (N,4,4)) — the per-step  sum_j obstacle_j cost derivs
      exactly as accumulated at Constraints.cpp:180-187.

    Per (obstacle j, step i) the math mirrors ``Obstacle::get_obstalce_cost``
    (Obstacle.cpp:39-112): safety half-axes
        a = len/2 + |v_o cos(th_o)| t_safe + s_safe_a + ego_rad
        b = wid/2 + |v_o sin(th_o)| t_safe + s_safe_b + ego_rad + 1
    c = 1 - d^T P d with d the ego front/rear disc center rotated into the
    obstacle frame; barrier q1*exp(q2*c); c_dot only populates the x/y slots
    (the rotation matrices embed a 2x2 block in a zero 4x4 — the reference's
    gradient deliberately ignores the theta-dependence of the disc centers).
    """
    N = X.shape[0]
    dims = obs.dims[:, :N]  # (M, N, 2)
    pos = obs.pos[:, :N]    # (M, N, 4)

    ov = pos[..., 2]
    oth = pos[..., 3]
    a = dims[..., 0] / 2.0 + jnp.abs(ov * jnp.cos(oth)) * p.t_safe + p.s_safe_a + p.ego_rad
    b = dims[..., 1] / 2.0 + jnp.abs(ov * jnp.sin(oth)) * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
    inv_a2 = 1.0 / (a * a)  # (M, N)
    inv_b2 = 1.0 / (b * b)

    co, so = jnp.cos(oth), jnp.sin(oth)  # rotation into obstacle frame

    vth = X[:, 3]
    cth, sth = jnp.cos(vth), jnp.sin(vth)

    def disc(offset_sign: float, reach: float, q1: float, q2: float):
        # ego disc center in global frame (Obstacle.cpp:65-68, 86-89)
        ex = X[:, 0] + offset_sign * cth * reach  # (N,)
        ey = X[:, 1] + offset_sign * sth * reach
        dxg = ex[None, :] - pos[..., 0]  # (M, N)
        dyg = ey[None, :] - pos[..., 1]
        # rotate into obstacle frame: tf = [[c, s], [-s, c]]
        dx = co * dxg + so * dyg
        dy = -so * dxg + co * dyg
        c_val = 1.0 - (dx * dx * inv_a2 + dy * dy * inv_b2)
        # c_dot = -2 * R(th)^T_applied... (Obstacle.cpp:82): rotate the scaled
        # obstacle-frame gradient back to global with [[c, -s], [s, c]]
        gx_o = dx * inv_a2
        gy_o = dy * inv_b2
        gx = -2.0 * (co * gx_o - so * gy_o)  # (M, N)
        gy = -2.0 * (so * gx_o + co * gy_o)
        e = q1 * jnp.exp(q2 * c_val)  # (M, N)
        # vx rows: [gx, gy, 0, 0] scaled by q2*e
        vx2 = jnp.stack([gx, gy], axis=-1) * (q2 * e)[..., None]  # (M, N, 2)
        # Gauss-Newton mx on the xy block only
        g2 = jnp.stack([gx, gy], axis=-1)
        mx2 = (q2 * q2 * e)[..., None, None] * (g2[..., :, None] * g2[..., None, :])
        return vx2, mx2

    fvx, fmx = disc(+1.0, p.ego_front, p.q1_front, p.q2_front)
    rvx, rmx = disc(-1.0, p.ego_rear, p.q1_rear, p.q2_rear)

    m = obs.mask[:, None, None]  # (M, 1, 1)
    vx2 = jnp.sum((fvx + rvx) * m, axis=0)  # (N, 2)
    mx2 = jnp.sum((fmx + rmx) * m[..., None], axis=0)  # (N, 2, 2)

    vx = jnp.zeros((N, 4), dtype=X.dtype).at[:, :2].set(vx2)
    mx = jnp.zeros((N, 4, 4), dtype=X.dtype).at[:, :2, :2].set(mx2)
    return vx, mx
