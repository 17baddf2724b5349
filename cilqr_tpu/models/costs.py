"""Cost stack: tracking + exponential barriers, with analytic 1st/2nd derivs.

Reference semantics: ``CILQR/src/ilqr/include/ilqr/Constraints.cpp``.

Everything is evaluated for the whole horizon at once (shape (N, ...)) —
replacing the reference's dead ThreadPool experiments (Constraints.cpp:229-493)
with plain vectorization.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cilqr_tpu.models import obstacles as obstacles_mod
from cilqr_tpu.models import uncertainty as uncertainty_mod
from cilqr_tpu.models.reference_path import LocalPlan, find_closest_points
from cilqr_tpu.utils.params import SolverParams


class CostDerivs(NamedTuple):
    l_x: jax.Array   # (N, 4)
    l_xx: jax.Array  # (N, 4, 4)
    l_u: jax.Array   # (N, 2)
    l_uu: jax.Array  # (N, 2, 2)
    l_ux: jax.Array  # (N, 2, 4) — identically zero (Constraints.cpp:501-506)


def barrier(q1: float, q2: float, c: jax.Array, c_dot: jax.Array):
    """Exponential barrier  b = q1*exp(q2*c)  with gradient & Gauss-Newton
    Hessian (Constraints.cpp:67-78).

    c: (...,); c_dot: (..., D).  Returns (b, vx (...,D), mx (...,D,D)).
    """
    b = q1 * jnp.exp(q2 * c)
    vx = (q2 * b)[..., None] * c_dot
    mx = (q2 * q2 * b)[..., None, None] * (c_dot[..., :, None] * c_dot[..., None, :])
    return b, vx, mx


def control_cost_derivs(p: SolverParams, X: jax.Array, U: jax.Array):
    """l_u (N,2), l_uu (N,2,2) — quadratic effort + 4 control barriers
    (Constraints.cpp:86-137).

    The yaw-rate bounds are state-dependent: |yawrate| <= v*tan(steer)/L at
    the concurrent state X[i] (Constraints.cpp:119-121).
    """
    N = U.shape[0]
    dtype = U.dtype
    v = X[:N, 2]
    acc = U[:, 0]
    yr = U[:, 1]

    e1 = jnp.array([1.0, 0.0], dtype=dtype)
    e2 = jnp.array([0.0, 1.0], dtype=dtype)
    eN1 = jnp.broadcast_to(e1, (N, 2))
    eN2 = jnp.broadcast_to(e2, (N, 2))

    _, v1, m1 = barrier(p.q1_acc, p.q2_acc, acc - p.acc_max, eN1)
    _, v2, m2 = barrier(p.q1_acc, p.q2_acc, p.acc_min - acc, -eN1)

    yr_hi = v * jnp.tan(p.steer_angle_max) / p.wheelbase
    yr_lo = v * jnp.tan(p.steer_angle_min) / p.wheelbase
    _, v3, m3 = barrier(p.q1_yawrate, p.q2_yawrate, yr - yr_hi, eN2)
    _, v4, m4 = barrier(p.q1_yawrate, p.q2_yawrate, yr_lo - yr, -eN2)

    R = jnp.array([[p.w_acc, 0.0], [0.0, p.w_yawrate]], dtype=dtype)
    # HIGHEST: a float32 product may otherwise run in TF32 on a GPU
    hp = jax.lax.Precision.HIGHEST
    l_u = v1 + v2 + v3 + v4 + 2.0 * jnp.matmul(U, R, precision=hp)
    l_uu = m1 + m2 + m3 + m4 + 2.0 * jnp.broadcast_to(R, (N, 2, 2))
    return l_u, l_uu


def tracking_cost_derivs(p: SolverParams, plan: LocalPlan, X: jax.Array, cp=None):
    """Quadratic tracking l_x/l_xx (Constraints.cpp:161-175).

    Yaw is untracked: the error row 3 is zeroed and state_cost(3,3) is never
    set (Constraints.cpp:9-13,168).  ``cp`` takes precomputed closest points
    so fused callers share one lookup pass.
    """
    N = X.shape[0]
    dtype = X.dtype
    if cp is None:
        cp = find_closest_points(plan, X)  # (N, 2)
    err = jnp.stack(
        [
            X[:, 0] - cp[:, 0],
            X[:, 1] - cp[:, 1],
            X[:, 2] - p.desired_speed,
            jnp.zeros((N,), dtype=dtype),
        ],
        axis=-1,
    )
    Q = jnp.diag(jnp.array([p.w_pos, p.w_pos, p.w_vel, 0.0], dtype=dtype))
    l_x = 2.0 * jnp.matmul(err, Q, precision=jax.lax.Precision.HIGHEST)
    l_xx = jnp.broadcast_to(2.0 * Q, (N, 4, 4))
    return l_x, l_xx


def state_cost_derivs(
    p: SolverParams,
    plan: LocalPlan,
    X: jax.Array,
    obstacles: Optional["obstacles_mod.Obstacles"] = None,
    unc_map: Optional["uncertainty_mod.UncertaintyMap"] = None,
    cp=None,
    unc_onehot: bool = True,
):
    """Full l_x (N,4), l_xx (N,4,4): tracking + obstacle barriers +
    uncertainty-map barrier (Constraints.cpp:145-227).

    ``X`` must be the first N states of the (N+1)-long trajectory — the
    reference evaluates state costs at columns 0..N-1 (Constraints.cpp:161).
    """
    l_x, l_xx = tracking_cost_derivs(p, plan, X, cp=cp)
    if obstacles is not None:
        ovx, omx = obstacles_mod.obstacle_cost_derivs(p, obstacles, X)
        l_x = l_x + p.w_obstacle * ovx
        l_xx = l_xx + p.w_obstacle * omx
    if unc_map is not None:
        _, uvx, umx = uncertainty_mod.uncertainty_cost(p, unc_map, X,
                                                       use_onehot=unc_onehot)
        l_x = l_x + p.w_uncertainty * uvx
        l_xx = l_xx + p.w_uncertainty * umx
    return l_x, l_xx


def total_cost_J(p: SolverParams, plan: LocalPlan, X: jax.Array, U: jax.Array,
                 cp=None) -> jax.Array:
    """Line-search acceptance cost J (Constraints.cpp:534-561).

    Parity quirk preserved: J counts *only* the quadratic tracking and control
    terms — all barrier and uncertainty terms are excluded (the uncertainty
    contribution is commented out at Constraints.cpp:554-557).  The tracking
    error here does include the yaw slot, but Q(3,3)=0 kills it.
    """
    N = U.shape[0]
    dtype = X.dtype
    Xh = X[:N]
    if cp is None:
        cp = find_closest_points(plan, Xh)
    err = jnp.stack(
        [
            Xh[:, 0] - cp[:, 0],
            Xh[:, 1] - cp[:, 1],
            Xh[:, 2] - p.desired_speed,
            Xh[:, 3],
        ],
        axis=-1,
    )
    Q = jnp.array([p.w_pos, p.w_pos, p.w_vel, 0.0], dtype=dtype)
    R = jnp.array([p.w_acc, p.w_yawrate], dtype=dtype)
    x_cost = jnp.sum(err * err * Q[None, :])
    u_cost = jnp.sum(U * U * R[None, :])
    return x_cost + u_cost


def all_cost_derivs(
    p: SolverParams,
    plan: LocalPlan,
    X: jax.Array,
    U: jax.Array,
    obstacles=None,
    unc_map=None,
) -> CostDerivs:
    """Everything the backward pass needs, in one fused evaluation."""
    N = U.shape[0]
    l_x, l_xx = state_cost_derivs(p, plan, X[:N], obstacles, unc_map)
    l_u, l_uu = control_cost_derivs(p, X, U)
    l_ux = jnp.zeros((N, 2, 4), dtype=X.dtype)
    return CostDerivs(l_x, l_xx, l_u, l_uu, l_ux)


def all_cost_derivs_and_J(
    p: SolverParams,
    plan: LocalPlan,
    X: jax.Array,
    U: jax.Array,
    obstacles=None,
    unc_map=None,
    unc_onehot: bool = True,
):
    """Fused (CostDerivs, J): one closest-point pass serves both the
    tracking derivatives (Constraints.cpp:161-175) and the acceptance cost
    (Constraints.cpp:534-561) since both evaluate at X[0..N-1] — the
    reference recomputes the 200-sample scan twice per LM iteration
    (backward_pass + get_J, iLQR.cpp:213,217)."""
    N = U.shape[0]
    Xh = X[:N]
    cp = find_closest_points(plan, Xh)  # (N, 2) shared
    l_x, l_xx = state_cost_derivs(p, plan, Xh, obstacles, unc_map, cp=cp,
                                  unc_onehot=unc_onehot)
    l_u, l_uu = control_cost_derivs(p, X, U)
    l_ux = jnp.zeros((N, 2, 4), dtype=X.dtype)
    J = total_cost_J(p, plan, X, U, cp=cp)
    return CostDerivs(l_x, l_xx, l_u, l_uu, l_ux), J
