"""Constant-velocity bounding-box Kalman tracker — jittable.

Reference semantics: the OpenCV KalmanFilter wired into the costmap node
(``local_costmap.cpp:138-159`` setup, ``bboxCallback`` :328-394): 6 states
[cx, cy, w, h, vx, vy], 4 measurements [cx, cy, w, h], transition adding the
velocity to the position block, Q = 1e-5 I, R = 1e-1 I, P0 = I.  The
reference's sanity gate (out-of-range boxes reset the filter,
local_costmap.cpp:331-336) is ``reset_on_invalid``.

Also subsumes the dead ``KF.h`` header (map_engine/include/KF.h:7-127 — an
unused Eigen Kalman filter referencing an undefined ``Tools`` class).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class KFState(NamedTuple):
    x: jax.Array  # (6,) [cx, cy, w, h, vx, vy]
    P: jax.Array  # (6, 6)


def _matrices(dtype):
    # transition (local_costmap.cpp:145-152): x,y integrate vx,vy; w,h const
    F = jnp.eye(6, dtype=dtype)
    F = F.at[0, 4].set(1.0).at[1, 5].set(1.0)
    H = jnp.zeros((4, 6), dtype=dtype).at[:4, :4].set(jnp.eye(4, dtype=dtype))
    Q = 1e-5 * jnp.eye(6, dtype=dtype)
    R = 1e-1 * jnp.eye(4, dtype=dtype)
    return F, H, Q, R


def init(dtype=jnp.float32, x0=None) -> KFState:
    x = jnp.zeros((6,), dtype) if x0 is None else jnp.asarray(x0, dtype)
    return KFState(x, jnp.eye(6, dtype=dtype))


def predict(s: KFState) -> KFState:
    # HIGHEST precision: batched 6x6 dots at default precision (bf16 or
    # TF32 operands) degrade the covariance recursion
    with jax.default_matmul_precision("highest"):
        F, _, Q, _ = _matrices(s.x.dtype)
        return KFState(F @ s.x, F @ s.P @ F.T + Q)


def correct(s: KFState, z: jax.Array) -> KFState:
    with jax.default_matmul_precision("highest"):
        F, H, Q, R = _matrices(s.x.dtype)
        y = z - H @ s.x
        S = H @ s.P @ H.T + R
        K = jnp.linalg.solve(S.T, (s.P @ H.T).T).T  # P H^T S^-1 without inverse
        x = s.x + K @ y
        P = (jnp.eye(6, dtype=s.x.dtype) - K @ H) @ s.P
        return KFState(x, P)


def step(s: KFState, z: jax.Array, valid: jax.Array) -> tuple[KFState, jax.Array]:
    """predict+correct if valid, else coast -> smoothed box.

    ``valid`` mirrors the bbox sanity gate: on an out-of-range measurement
    the reference clears the rasterized layer and leaves the filter state
    untouched (local_costmap.cpp:331-336) — so here the track coasts (no
    update) and the returned box is zeroed (nothing to rasterize).
    Returns (new_state, (4,) smoothed [cx, cy, w, h]).
    """
    sc = correct(predict(s), z)
    out = jax.tree.map(lambda a, b: jnp.where(valid, a, b), sc, s)
    box = jnp.where(valid, out.x[:4], jnp.zeros(4, s.x.dtype))
    return out, box


def track(zs: jax.Array, valids: jax.Array, dtype=jnp.float32):
    """Run the tracker over a (T, 4) measurement stream via lax.scan."""
    def body(s, inp):
        z, v = inp
        return step(s, z.astype(dtype), v)

    s0 = init(dtype=dtype, x0=jnp.concatenate([zs[0].astype(dtype), jnp.zeros(2, dtype)]))
    _, boxes = jax.lax.scan(body, s0, (zs, valids))
    return boxes
