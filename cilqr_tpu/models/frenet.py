"""Frenet-frame lattice planner — the reference's `Frenet/` baseline.

The reference repo ships only run instructions for this algorithm
(`Frenet/readme.md:1-55` — the implementation lived outside the snapshot),
including its three uncertainty-handling ablation modes:

  * ``origin``      — ignore localization uncertainty (sigmas = 0 everywhere);
  * ``expansion``   — inflate obstacle footprints by the chi * sigma
    confidence bound (the classic "grow the obstacle" heuristic);
  * ``propagation`` — consume the propagated uncertainty costmap exactly like
    the CILQR planner does (`Frenet/readme.md:12-15`: map_engine sigmas live).

This is a ground-up JAX implementation of the standard optimal-frenet
lattice method (Werling et al., ICRA 2010), shaped for XLA:

  * the candidate set is a STATIC (n_lat x n_T x n_v) lattice, evaluated for
    every candidate and every horizon step in one dense broadcast — no
    per-candidate Python loops, no dynamic pruning;
  * infeasible candidates are masked (+inf cost), the winner is selected by
    argmin and fetched with a one-hot contraction at HIGHEST precision;
  * the full planner is one jittable function, vmappable over scenario
    batches and shardable over meshes like the CILQR solver.

The reference line reuses the CILQR local-plan machinery (global-plan window
+ degree-5 polyfit + densified sample table, `LocalPlanner.cpp`,
`Constraints.cpp:24-59`) so both planners track the identical path — the
property the reference's algorithm comparison relies on
(`batch_dataprocess.py:459-463` compares CILQR vs Frenet on the same routes).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cilqr_tpu.models import reference_path as rp
from cilqr_tpu.ops import gridmap
from cilqr_tpu.utils.params import SolverParams

MODES = ("origin", "expansion", "propagation")


@dataclasses.dataclass(frozen=True)
class FrenetParams:
    """Lattice geometry, cost weights and uncertainty mode.

    Cost weights follow the standard Werling formulation: jerk (k_j), time
    (k_t), terminal lateral offset (k_d), terminal speed error (k_v), and the
    lat/lon combination weights.
    """

    mode: str = "origin"

    # lattice.  T_min=1.0 keeps late swerves representable (a receding-
    # horizon lattice re-starts its maneuver clock every cycle, so long-
    # duration-only candidates never build lateral speed); v_frac_min=0.0
    # includes full braking maneuvers so a blocked corridor degrades to a
    # stop instead of an infeasible set.
    n_lat: int = 9           # lateral end-offset candidates in [-d_max, d_max]
    d_max: float = 3.0
    n_T: int = 4             # maneuver durations in [T_min, T_max]
    T_min: float = 1.0
    T_max: float = 4.0
    n_v: int = 5             # target speeds in [v_frac_min, v_frac_max]*v_des
    v_frac_min: float = 0.0
    v_frac_max: float = 1.2

    # cost weights
    k_j: float = 0.1
    k_t: float = 0.1
    k_d: float = 1.0
    k_v: float = 1.0
    k_lat: float = 1.0
    k_lon: float = 1.0

    # feasibility limits default to the ego limits in SolverParams; the
    # collision margin matches the CILQR ego-disc radius model
    collision_margin: float = 0.5

    # uncertainty handling
    expansion_chi: float = 2.4477  # 95% confidence (chisquare_val, ARBIT.cuh)
    unc_threshold: float = 80.0    # propagation mode: cells above block
    w_unc: float = 2.0             # propagation mode: integrated-occupancy weight

    @property
    def n_candidates(self) -> int:
        return self.n_lat * self.n_T * self.n_v

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")


class FrenetResult(NamedTuple):
    """Best-candidate trajectory, field-compatible with ``SolveResult``."""

    X: jax.Array           # (N+1, 4) [x, y, v, theta]
    U: jax.Array           # (N, 2) finite-difference [accel, yaw-rate]
    ref_x: jax.Array       # (num_of_local_wpts,)
    ref_y: jax.Array
    iterations: jax.Array  # () selected candidate index (telemetry slot)
    J: jax.Array           # () winning candidate cost
    lamb: jax.Array        # () 1.0 if any candidate feasible else 0.0


def _quintic(T, p0, v0, a0, p1, v1, a1):
    """Quintic boundary solve in the tau = t/T basis.

    d(tau) = p0 + v0*T*tau + a0*T^2/2*tau^2 + b3*tau^3 + b4*tau^4 + b5*tau^5
    with (position, velocity, accel) matched at tau=1.  The 3x3 system has
    the constant matrix [[1,1,1],[3,4,5],[6,12,20]] (det 2) — closed form.
    """
    h = p1 - p0 - v0 * T - 0.5 * a0 * T * T
    g = (v1 - v0 - a0 * T) * T
    f = (a1 - a0) * T * T
    b3 = 0.5 * (20.0 * h - 8.0 * g + f)
    b4 = 0.5 * (-30.0 * h + 14.0 * g - 2.0 * f)
    b5 = 0.5 * (12.0 * h - 6.0 * g + f)
    return b3, b4, b5


def _quartic(T, p0, v0, a0, v1, a1):
    """Quartic (free end position): velocity/accel matched at tau=1."""
    g = (v1 - v0 - a0 * T) * T
    f = (a1 - a0) * T * T
    b3 = g - f / 3.0
    b4 = -0.5 * g + 0.25 * f
    return b3, b4


def _jerk_integral(T, a0, b3, b4, b5):
    """Closed-form integral of squared jerk over [0, T] in the tau basis.

    jerk(t) = (1/T^3) * (6 b3 + 24 b4 tau + 60 b5 tau^2); the tau-basis
    quadratic-square integral is analytic.  a0 enters only tau^2 and lower —
    zero third derivative — so it does not appear.
    """
    c = 6.0 * b3
    d = 24.0 * b4
    e = 60.0 * b5
    integ = (c * c + c * d + (d * d + 2.0 * c * e) / 3.0
             + d * e / 2.0 + e * e / 5.0)
    return integ / jnp.maximum(T, 1e-6) ** 5


class _RefLine(NamedTuple):
    s: jax.Array      # (S,) cumulative arclength of the densified table
    x: jax.Array      # (S,)
    y: jax.Array      # (S,)
    tx: jax.Array     # (S,) unit tangent
    ty: jax.Array


def _ref_line(plan: rp.LocalPlan) -> _RefLine:
    x, y = plan.sample_x, plan.sample_y
    dx = jnp.gradient(x)
    dy = jnp.gradient(y)
    ds = jnp.sqrt(dx * dx + dy * dy)
    norm = jnp.maximum(ds, 1e-9)
    seg = jnp.sqrt(jnp.diff(x) ** 2 + jnp.diff(y) ** 2)
    s = jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(seg)])
    return _RefLine(s, x, y, dx / norm, dy / norm)


def _project(ref: _RefLine, pos_xy: jax.Array):
    """(s, d) of a global point on the densified reference line."""
    d2 = (ref.x - pos_xy[0]) ** 2 + (ref.y - pos_xy[1]) ** 2
    i = jnp.argmin(d2)
    sx, sy, tx, ty, s0 = (a[i] for a in (ref.x, ref.y, ref.tx, ref.ty, ref.s))
    ex, ey = pos_xy[0] - sx, pos_xy[1] - sy
    s0 = s0 + tx * ex + ty * ey           # tangential correction
    d0 = -ty * ex + tx * ey               # signed offset (left positive)
    return s0, d0, jnp.arctan2(ty, tx)


def plan_step(
    p: SolverParams,
    fp: FrenetParams,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    ego_state: jax.Array,
    obstacles=None,
    unc_map=None,
    sigmas: Optional[jax.Array] = None,
) -> FrenetResult:
    """One Frenet lattice planning cycle at ``ego_state`` ([x, y, v, theta]).

    Args:
      obstacles: ``models.obstacles.Obstacles`` pytree (padded; mask-aware).
      unc_map:   ``models.uncertainty.UncertaintyMap`` (propagation mode).
      sigmas:    (3,) [sigma_x, sigma_y, sigma_theta] localization noise used
                 by expansion mode; ignored otherwise.
    """
    dtype = ego_state.dtype
    plan = rp.get_local_plan(p, plan_xy, plan_n, ego_state)
    ref = _ref_line(plan)

    s0, d0, th_ref0 = _project(ref, ego_state[:2])
    v0 = ego_state[2]
    dth = ego_state[3] - th_ref0
    s_dot0 = v0 * jnp.cos(dth)
    d_dot0 = v0 * jnp.sin(dth)

    # ---------------- candidate lattice (static shapes) ----------------
    d_f = jnp.linspace(-fp.d_max, fp.d_max, fp.n_lat, dtype=dtype)
    T_f = jnp.linspace(fp.T_min, fp.T_max, fp.n_T, dtype=dtype)
    v_f = jnp.linspace(
        fp.v_frac_min * p.desired_speed, fp.v_frac_max * p.desired_speed,
        fp.n_v, dtype=dtype,
    )
    D, T, V = jnp.meshgrid(d_f, T_f, v_f, indexing="ij")
    D, T, V = D.ravel(), T.ravel(), V.ravel()        # (K,)
    K = fp.n_candidates

    # lateral quintic (d0, d_dot0, 0) -> (D, 0, 0) over T
    lb3, lb4, lb5 = _quintic(T, d0, d_dot0, 0.0, D, 0.0, 0.0)
    # longitudinal quartic (s_dot0, 0) -> (V, 0) over T (free end position)
    sb3, sb4 = _quartic(T, s0, s_dot0, 0.0, V, 0.0)

    N = p.horizon
    t = jnp.arange(N + 1, dtype=dtype) * p.timestep   # (N+1,)
    tc = jnp.minimum(t[None, :], T[:, None])          # (K, N+1) clamp at T
    tau = tc / T[:, None]

    def lat_eval(tau):
        d = (d0 + d_dot0 * T[:, None] * tau
             + lb3[:, None] * tau**3 + lb4[:, None] * tau**4 + lb5[:, None] * tau**5)
        dd = (d_dot0 * T[:, None]
              + 3 * lb3[:, None] * tau**2 + 4 * lb4[:, None] * tau**3
              + 5 * lb5[:, None] * tau**4) / T[:, None]
        return d, dd

    d_t, d_dot_t = lat_eval(tau)
    # after T the maneuver holds: d = D, d_dot = 0 (tau clamped at 1 already
    # gives exactly that because the quintic ends at (D, 0, 0))

    s_t = (s0 + s_dot0 * T[:, None] * tau
           + sb3[:, None] * tau**3 + sb4[:, None] * tau**4)
    s_dot_t = (s_dot0 * T[:, None]
               + 3 * sb3[:, None] * tau**2 + 4 * sb4[:, None] * tau**3) / T[:, None]
    s_ddot_t = (6 * sb3[:, None] * tau + 12 * sb4[:, None] * tau**2) / T[:, None] ** 2
    # past T: constant speed V
    past = t[None, :] > T[:, None]
    s_t = jnp.where(past, s_t + V[:, None] * (t[None, :] - T[:, None]), s_t)
    s_dot_t = jnp.where(past, V[:, None], s_dot_t)
    s_ddot_t = jnp.where(past, 0.0, s_ddot_t)

    # ---------------- frenet -> global ----------------
    xr = jnp.interp(s_t, ref.s, ref.x)
    yr = jnp.interp(s_t, ref.s, ref.y)
    txr = jnp.interp(s_t, ref.s, ref.tx)   # tangent components interpolate
    tyr = jnp.interp(s_t, ref.s, ref.ty)   # without angle-wrap issues
    tn = jnp.sqrt(txr * txr + tyr * tyr)
    txr, tyr = txr / jnp.maximum(tn, 1e-9), tyr / jnp.maximum(tn, 1e-9)

    gx = xr - d_t * tyr
    gy = yr + d_t * txr
    gv = jnp.sqrt(s_dot_t**2 + d_dot_t**2)
    gyaw = jnp.arctan2(tyr, txr) + jnp.arctan2(
        d_dot_t, jnp.maximum(s_dot_t, 1e-3)
    )

    X = jnp.stack([gx, gy, gv, gyaw], axis=-1)  # (K, N+1, 4)

    # ---------------- cost ----------------
    J_lat = (fp.k_j * _jerk_integral(T, 0.0, lb3, lb4, lb5)
             + fp.k_t * T + fp.k_d * D * D)
    J_lon = (fp.k_j * _jerk_integral(T, 0.0, sb3, sb4, jnp.zeros_like(sb3))
             + fp.k_t * T + fp.k_v * (V - p.desired_speed) ** 2)
    J = fp.k_lat * J_lat + fp.k_lon * J_lon  # (K,)

    # ---------------- feasibility ----------------
    feasible = jnp.ones((K,), bool)
    feasible &= jnp.all(s_ddot_t <= p.acc_max + 1e-6, axis=1)
    feasible &= jnp.all(s_ddot_t >= p.acc_min - 1e-6, axis=1)
    feasible &= jnp.all(gv <= p.speed_max + 1e-6, axis=1)
    feasible &= jnp.all(s_dot_t >= -1e-6, axis=1)   # no reversing
    # curvature from yaw finite differences over arclength
    dyaw = jnp.diff(jnp.unwrap(gyaw, axis=1), axis=1)
    darc = jnp.maximum(jnp.diff(s_t, axis=1), 1e-3)
    kappa_max = jnp.tan(p.steer_angle_max) / p.wheelbase
    feasible &= jnp.all(jnp.abs(dyaw / darc) <= kappa_max * 1.5, axis=1)

    # ---------------- obstacles (mode-dependent inflation) ----------------
    if obstacles is not None:
        if fp.mode == "expansion":
            if sigmas is None:
                raise ValueError("expansion mode needs sigmas=(sx, sy, stheta)")
            infl = fp.expansion_chi * jnp.maximum(sigmas[0], sigmas[1])
        else:
            infl = jnp.asarray(0.0, dtype)
        M = obstacles.pos.shape[0]
        opos = obstacles.pos[:, : N + 1]     # (M, N', 4) padded tracks
        odim = obstacles.dims[:, : N + 1]
        # obstacle tracks are per-solver-horizon; broadcast the final pose
        # forward if the planner horizon extends past the track
        Nt = opos.shape[1]
        if Nt < N + 1:
            opos = jnp.concatenate(
                [opos, jnp.broadcast_to(opos[:, -1:], (M, N + 1 - Nt, 4))], axis=1)
            odim = jnp.concatenate(
                [odim, jnp.broadcast_to(odim[:, -1:], (M, N + 1 - Nt, 2))], axis=1)
        a = odim[..., 0] / 2.0 + fp.collision_margin + p.ego_rad + infl  # (M, N+1)
        b = odim[..., 1] / 2.0 + fp.collision_margin + p.ego_rad + infl
        co, so = jnp.cos(opos[..., 3]), jnp.sin(opos[..., 3])

        # broadcast (M, 1, N+1) obstacles against (1, K, N+1) candidates
        def hit_for(sign, reach):
            ex = gx + sign * jnp.cos(gyaw) * reach          # (K, N+1)
            ey = gy + sign * jnp.sin(gyaw) * reach
            dxg = ex[None, :, :] - opos[:, None, :, 0]      # (M, K, N+1)
            dyg = ey[None, :, :] - opos[:, None, :, 1]
            dxo = co[:, None] * dxg + so[:, None] * dyg
            dyo = -so[:, None] * dxg + co[:, None] * dyg
            q = (dxo / a[:, None]) ** 2 + (dyo / b[:, None]) ** 2
            inside = q < 1.0
            return inside & (obstacles.mask[:, None, None] > 0)

        hits = hit_for(+1.0, p.ego_front) | hit_for(-1.0, p.ego_rear)
        feasible &= ~jnp.any(hits, axis=(0, 2))

    # ---------------- uncertainty costmap (propagation mode) ----------------
    if fp.mode == "propagation" and unc_map is not None:
        dxy = X[..., :2] - unc_map.origin_xy
        cy, sy_ = jnp.cos(unc_map.origin_yaw), jnp.sin(unc_map.origin_yaw)
        local = jnp.stack(
            [cy * dxy[..., 0] + sy_ * dxy[..., 1],
             -sy_ * dxy[..., 0] + cy * dxy[..., 1]], axis=-1)
        flat = local.reshape(-1, 2)
        u, _ = gridmap.sample_bilinear_with_grad(unc_map.values, unc_map.geom, flat)
        inside = gridmap.in_bounds(unc_map.geom, flat)
        u = jnp.where(inside, u, 0.0).reshape(K, N + 1)
        feasible &= jnp.all(u < fp.unc_threshold, axis=1)
        J = J + fp.w_unc * jnp.mean(u / 100.0, axis=1)

    # ---------------- select ----------------
    any_ok = jnp.any(feasible)
    J_masked = jnp.where(feasible, J, jnp.inf)
    best = jnp.argmin(jnp.where(any_ok, J_masked, J))

    oh = jax.nn.one_hot(best, K, dtype=dtype)
    Xb = jnp.einsum("k,knf->nf", oh, X,
                    precision=jax.lax.Precision.HIGHEST)   # (N+1, 4)

    # Emergency-brake fallback: when NO candidate is collision-free the
    # planner must not execute the least-cost colliding maneuver — it
    # brakes at the actuation limit along the current heading (the
    # trajectory the caller sees still carries .lamb == 0).
    vb = jnp.maximum(v0 + p.acc_min * t, 0.0)               # (N+1,)
    step_d = vb[:-1] * p.timestep
    sb = jnp.concatenate([jnp.zeros((1,), dtype), jnp.cumsum(step_d)])
    yaw0 = ego_state[3]
    X_brake = jnp.stack(
        [ego_state[0] + sb * jnp.cos(yaw0),
         ego_state[1] + sb * jnp.sin(yaw0),
         vb,
         jnp.broadcast_to(yaw0, vb.shape)], axis=-1)
    Xb = jnp.where(any_ok, Xb, X_brake)

    dv = jnp.diff(Xb[:, 2]) / p.timestep
    dyaw_dt = jnp.diff(jnp.unwrap(Xb[:, 3])) / p.timestep
    # Clamp the emitted finite-difference controls to the plant's actuation
    # bounds (Model.cpp:19-20 semantics: acc box + state-dependent yaw-rate
    # bound v*tan(steer_max)/L at each step's speed).  The plant clamps
    # anyway, but the *recorded* U must never claim infeasible actuation.
    from cilqr_tpu.models import dynamics as _dyn

    U = jnp.stack([dv, dyaw_dt], axis=-1)                  # (N, 2)
    U = _dyn.clamp_control(p, Xb[:-1], U)

    return FrenetResult(
        X=Xb,
        U=U,
        ref_x=plan.x_wpts,
        ref_y=plan.y_fit,
        iterations=best.astype(jnp.int32),
        # NOT a one-hot dot: J_masked holds +inf on masked candidates and
        # 0 * inf = nan; the winner's cost is simply the min
        J=jnp.where(any_ok, jnp.min(J_masked), jnp.min(J)),
        lamb=any_ok.astype(dtype),
    )
