"""Kinematic bicycle dynamics — vectorized and scan-friendly.

Reference semantics: ``CILQR/src/ilqr/include/ilqr/Model.cpp``.

State   x = [px, py, v, theta]     (shape (4,))
Control u = [acc, yaw_rate]        (shape (2,))

All functions are pure and `jit`/`vmap`-safe.  The horizon axis is the
*leading* axis (shape ``(N, 4)`` / ``(N, 2)``) — the natural layout for
``lax.scan`` and for batching scenarios on top via ``vmap``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cilqr_tpu.utils.params import SolverParams


def clamp_control(p: SolverParams, x: jax.Array, u: jax.Array) -> jax.Array:
    """Input clamping applied before integration (Model.cpp:19-20).

    acc is clamped to [acc_min, acc_max]; yaw-rate to the *state-dependent*
    bound  v * tan(steer_angle) / wheelbase  evaluated at the current speed.
    """
    acc = jnp.clip(u[..., 0], p.acc_min, p.acc_max)
    v = x[..., 2]
    yr_hi = v * jnp.tan(p.steer_angle_max) / p.wheelbase
    yr_lo = v * jnp.tan(p.steer_angle_min) / p.wheelbase
    yawrate = jnp.clip(u[..., 1], yr_lo, yr_hi)
    return jnp.stack([acc, yawrate], axis=-1)


def step(p: SolverParams, x: jax.Array, u: jax.Array) -> jax.Array:
    """One Euler step with input clamping (Model.cpp:17-30).

    Exactly mirrors the reference ordering: positions integrate the clamped
    acceleration through the *unclamped* current speed; the speed update is
    clamped to [0, speed_max] after integration.
    """
    uc = clamp_control(p, x, u)
    dt = p.timestep
    px, py, v, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    acc, yawrate = uc[..., 0], uc[..., 1]

    ds = v * dt + 0.5 * acc * dt * dt
    nx = px + jnp.cos(th) * ds
    ny = py + jnp.sin(th) * ds
    nv = jnp.clip(v + acc * dt, 0.0, p.speed_max)
    nth = th + yawrate * dt
    return jnp.stack([nx, ny, nv, nth], axis=-1)


def rollout(p: SolverParams, x0: jax.Array, U: jax.Array) -> jax.Array:
    """Nominal trajectory from x0 under control sequence U (iLQR.cpp:51-62).

    Args:
      x0: (4,) initial state.
      U:  (N, 2) control sequence.
    Returns:
      X: (N+1, 4) state trajectory including x0.
    """

    def body(x, u):
        xn = step(p, x, u)
        return xn, xn

    _, Xs = jax.lax.scan(body, x0, U, unroll=p.scan_unroll)
    return jnp.concatenate([x0[None, :], Xs], axis=0)


def jacobians(
    p: SolverParams, v: jax.Array, theta: jax.Array, acc: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Analytic discrete-dynamics Jacobians fx (N,4,4), fu (N,4,2).

    Mirrors ``Model::get_A_matrix``/``get_B_matrix`` (Model.cpp:100-155);
    the reference stores the *transposed* stacks ((4,4,N) col-major "A.T") and
    compensates by multiplying un-transposed in the backward pass
    (iLQR.cpp:149-153); here we use the standard orientation
    fx = d f / d x so that Q_x = l_x + fx^T V_x.

    NOTE (parity quirk): the reference evaluates these at the *successor*
    states — v, theta are taken from X columns 1..N (iLQR.cpp:102-106) while
    acc comes from U row 0.  Callers must pass the same slices.
    """
    dt = p.timestep
    N = v.shape[0]
    c, s = jnp.cos(theta), jnp.sin(theta)
    ds = v * dt + 0.5 * acc * dt * dt
    z = jnp.zeros_like(v)
    o = jnp.ones_like(v)

    # rows of fx: d next / d [px, py, v, theta]
    fx = jnp.stack(
        [
            jnp.stack([o, z, dt * c, -s * ds], axis=-1),
            jnp.stack([z, o, dt * s, c * ds], axis=-1),
            jnp.stack([z, z, o, z], axis=-1),
            jnp.stack([z, z, z, o], axis=-1),
        ],
        axis=-2,
    )  # (N, 4, 4)

    fu = jnp.stack(
        [
            jnp.stack([0.5 * dt * dt * c, z], axis=-1),
            jnp.stack([0.5 * dt * dt * s, z], axis=-1),
            jnp.stack([dt * o, z], axis=-1),
            jnp.stack([z, dt * o], axis=-1),
        ],
        axis=-2,
    )  # (N, 4, 2)

    assert fx.shape == (N, 4, 4) and fu.shape == (N, 4, 2)
    return fx, fu
