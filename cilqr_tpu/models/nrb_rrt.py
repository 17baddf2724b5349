"""NRB-RRT baseline — risk-bounded kinodynamic RRT in JAX.

The reference's batch comparison includes an "NRB-RRT" algorithm column
(``CILQR/src/ilqr/src/batch_dataprocess.py:458``) pointing at the external
TSummersLab *Risk Bounded Nonlinear Robot Motion Planning* repository
(``/root/reference/README.md:19``) — no code ships in the reference, exactly
like CCNMPC and Frenet.  This module re-creates the comparison axis the way
``models/ccnmpc.py``/``models/frenet.py`` do: a real, tested planner behind
the same ``plan_step`` interface, designed for XLA rather than ported.

What it keeps from NRB-RRT* (Safaoui et al., the repo the reference cites):
  * kinodynamic tree growth with the same bicycle model the plant uses
    (control-sampled steering primitives, not straight-line edges);
  * the *distributionally-robust risk bound*: an edge is admissible only if
    every state on it keeps each obstacle's ellipse at a margin
    kappa(alpha) * sigma_pos(t), kappa = sqrt((1 - alpha)/alpha) — the
    Cantelli/DR chance-constraint tightening (distribution-free, the "NRB"
    part) — with sigma_pos grown along the plan horizon;
  * goal-directed sampling along the reference line.

Documented divergence: the asymptotic-optimality rewiring of RRT* is
omitted (a fixed ~100-node budget run at 10 Hz re-plans long before rewiring
pays; every array here is fixed-size so the whole tree growth jits as one
``fori_loop``).  Randomness is derived *deterministically from the ego
state* via ``jax.random.fold_in`` so the closed-loop ``plan_step`` interface
(state, warm-start) needs no key plumbing and runs are reproducible.

Static-shape design: the tree lives in fixed (max_nodes, ...) arrays; nearest-
node search is a masked argmin; steering evaluates ALL control primitives in
parallel (vmap) and picks the best admissible one; path extraction is a
parent-pointer gather unrolled to the horizon depth.  No dynamic shapes, no
host control flow — the planner vmaps over scenario batches like the others.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cilqr_tpu.models import dynamics
from cilqr_tpu.models import reference_path as rp
from cilqr_tpu.utils.params import SolverParams


@dataclasses.dataclass(frozen=True)
class NRBParams:
    """Tree size, steering primitives, and the risk bound."""

    n_iters: int = 96            # growth iterations (max_nodes = n_iters + 1)
    steer_steps: int = 4         # dynamics steps per edge (0.4 s at dt=0.1)
    n_yawrate: int = 5           # steering primitive grid
    n_acc: int = 3
    goal_bias: float = 0.3       # probability of sampling the plan end
    lat_max: float = 3.0         # lateral sampling band around the ref line
    # corridor-feasible band override (relative to the reference line):
    # when set, lateral targets sample uniform(lat_lo, lat_hi) instead of
    # +-lat_max.  A planner knows its lane boundaries from the route/map;
    # without this, a narrow-corridor scenario (the 2.1 m gauntlet lane)
    # collided 10/10 at sigma=0 purely because +-3 m targets sat inside
    # the walls — measuring sampler misconfiguration, not the DR-margin
    # wall-blindness the comparison axis is about.  Derived per scenario
    # by ``sim.runner.nrb_params_for_scenario``.
    lat_lo: float = None
    lat_hi: float = None
    risk_alpha: float = 0.05     # per-constraint admissible collision risk
    sigma_growth: float = 0.5    # sigma_pos(t) = sigma0 * sqrt(1 + growth*t*dt)
    collision_margin: float = 0.3
    w_speed: float = 0.3         # nearest-metric weights
    w_yaw: float = 1.0
    goal_weight: float = 2.0     # goal-distance weight in best-node selection
    seed: int = 0

    @property
    def max_nodes(self) -> int:
        return self.n_iters + 1

    @property
    def n_primitives(self) -> int:
        return self.n_yawrate * self.n_acc

    @property
    def kappa(self) -> float:
        """Cantelli/DR tightening sqrt((1-alpha)/alpha)."""
        a = self.risk_alpha
        return float(((1.0 - a) / a) ** 0.5)


class NRBResult(NamedTuple):
    """Field-compatible with ``SolveResult`` (like FrenetResult)."""

    X: jax.Array           # (N+1, 4)
    U: jax.Array           # (N, 2)
    ref_x: jax.Array
    ref_y: jax.Array
    iterations: jax.Array  # () number of nodes grown
    J: jax.Array           # () best path cost
    lamb: jax.Array        # () 1.0 if a risk-admissible path was found


def _risk_ok(p: SolverParams, np_: NRBParams, states, t_idx, obstacles,
             sigma0):
    """DR chance-constraint check for a (..., 4) state batch at step ``t_idx``.

    Each obstacle ellipse (half-axes from dims/2 + ego disc + margin) is
    inflated by kappa * sigma_pos(t); both ego discs (front/rear,
    Obstacle.cpp:39-112 geometry) must clear every live obstacle at its
    time-indexed pose.
    """
    if obstacles is None:
        return jnp.ones(states.shape[:-1], bool)
    dtype = states.dtype
    Nt = obstacles.pos.shape[1]
    ti = jnp.minimum(t_idx, Nt - 1)
    opos = obstacles.pos[:, ti]     # (M, ..., 4) via fancy index on axis 1
    odim = obstacles.dims[:, ti]    # (M, ..., 2)
    sig_t = sigma0 * jnp.sqrt(1.0 + np_.sigma_growth * ti.astype(dtype) * p.timestep)
    infl = np_.kappa * sig_t        # (...,) DR margin

    a = odim[..., 0] / 2.0 + p.ego_rad + np_.collision_margin + infl
    b = odim[..., 1] / 2.0 + p.ego_rad + np_.collision_margin + infl
    co, so = jnp.cos(opos[..., 3]), jnp.sin(opos[..., 3])

    yaw = states[..., 3]
    ok = jnp.ones(states.shape[:-1], bool)
    live = obstacles.mask.reshape((-1,) + (1,) * ok.ndim) > 0  # (M, 1...)
    for sign, reach in ((1.0, p.ego_front), (-1.0, p.ego_rear)):
        ex = states[..., 0] + sign * jnp.cos(yaw) * reach
        ey = states[..., 1] + sign * jnp.sin(yaw) * reach
        dx = ex[None] - opos[..., 0]
        dy = ey[None] - opos[..., 1]
        du = co * dx + so * dy
        dv = -so * dx + co * dy
        q = (du / a) ** 2 + (dv / b) ** 2
        ok &= ~jnp.any((q < 1.0) & live, axis=0)
    return ok


def plan_step(
    p: SolverParams,
    np_: NRBParams,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    ego_state: jax.Array,
    obstacles=None,
    unc_map=None,
    sigmas: Optional[jax.Array] = None,
) -> NRBResult:
    """One risk-bounded RRT planning cycle at ``ego_state``.

    Same signature family as ``frenet.plan_step``; ``unc_map`` is unused —
    NRB-RRT carries its own uncertainty machinery (the DR bound), which is
    the point of the comparison.  ``sigmas`` (3,) feeds sigma_pos
    (sqrt(sx^2 + sy^2)); defaults to 0 (pure geometric RRT).
    """
    dtype = ego_state.dtype
    N = p.horizon
    m = np_.steer_steps
    Nn = np_.max_nodes
    C = np_.n_primitives

    plan = rp.get_local_plan(p, plan_xy, plan_n, ego_state)
    wx, wy = plan.x_wpts, plan.y_fit              # (W,)
    W = wx.shape[0]
    tx = jnp.gradient(wx)
    ty = jnp.gradient(wy)
    # Guard |t|: get_local_plan repeats the last waypoint near the route end
    # (reference_path repeat-last behavior), where the gradient is exactly 0
    # and an unguarded divide would poison the sampler with NaNs.  With the
    # guard those slots sample ON the line (lat offset collapses), which is
    # the right degraded behavior in the final metres.
    tn = jnp.maximum(jnp.sqrt(tx * tx + ty * ty), 1e-6)
    nx, ny = -ty / tn, tx / tn                    # unit normals
    goal = jnp.stack([wx[-1], wy[-1]])

    sigma0 = (jnp.sqrt(sigmas[0] ** 2 + sigmas[1] ** 2).astype(dtype)
              if sigmas is not None else jnp.asarray(0.0, dtype))

    # deterministic per-state randomness: fold the ego bits into a fixed key
    bits = jax.lax.bitcast_convert_type(
        ego_state.astype(jnp.float32), jnp.int32)
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.key(np_.seed), bits[0] ^ bits[2]),
        bits[1] ^ bits[3])

    # steering primitive grid (clamped by the dynamics anyway)
    yr = jnp.linspace(-1.0, 1.0, np_.n_yawrate, dtype=dtype)
    ac = jnp.linspace(p.acc_min / 2.0, p.acc_max, np_.n_acc, dtype=dtype)
    YR, AC = jnp.meshgrid(yr, ac, indexing="ij")
    prims = jnp.stack([AC.ravel(), YR.ravel()], axis=-1)  # (C, 2) [a, yawrate-scale]

    # tree arrays
    states0 = jnp.zeros((Nn, 4), dtype).at[0].set(ego_state)
    parent0 = jnp.zeros((Nn,), jnp.int32)
    ctrl0 = jnp.zeros((Nn, 2), dtype)             # control that reached the node
    cost0 = jnp.zeros((Nn,), dtype)
    time0 = jnp.zeros((Nn,), jnp.int32)           # horizon step of the node
    valid0 = jnp.zeros((Nn,), bool).at[0].set(True)

    def grow(i, carry):
        states, parent, ctrl, cost, time, valid = carry
        k = jax.random.fold_in(key, i)
        k_goal, k_s, k_lat, k_v = jax.random.split(k, 4)

        # ---- sample a target (goal-biased, ref-line band) ----
        j = jax.random.randint(k_s, (), 0, W)
        lat_lo = -np_.lat_max if np_.lat_lo is None else np_.lat_lo
        lat_hi = np_.lat_max if np_.lat_hi is None else np_.lat_hi
        lat = jax.random.uniform(k_lat, (), dtype, lat_lo, lat_hi)
        samp = jnp.stack([wx[j] + lat * nx[j], wy[j] + lat * ny[j]])
        use_goal = jax.random.uniform(k_goal, (), dtype) < np_.goal_bias
        target = jnp.where(use_goal, goal, samp)
        v_t = jax.random.uniform(k_v, (), dtype, 0.0, p.desired_speed * 1.2)

        # ---- nearest valid node (masked weighted metric) ----
        d2 = (jnp.sum((states[:, :2] - target) ** 2, -1)
              + np_.w_speed * (states[:, 2] - v_t) ** 2)
        near = jnp.argmin(jnp.where(valid, d2, jnp.inf)).astype(jnp.int32)
        x_near = states[near]
        t_near = time[near]

        # ---- steer: integrate every primitive m steps ----
        # yaw-rate primitive scales the state-dependent bound so every
        # primitive stays actuation-feasible at any speed (Model.cpp:20)
        def roll(x, u_scale):
            def body(x, _):
                u = jnp.stack([
                    u_scale[0],
                    u_scale[1] * x[2] * p.yawrate_gain,
                ])
                xn = dynamics.step(p, x, u)
                return xn, xn
            xf, path = jax.lax.scan(body, x, None, length=m)
            return xf, path

        ends, paths = jax.vmap(lambda u: roll(x_near, u))(prims)  # (C,4),(C,m,4)

        # ---- DR risk check along every primitive edge ----
        t_edge = t_near + 1 + jnp.arange(m)                        # (m,)
        ok = _risk_ok(p, np_, paths, jnp.broadcast_to(t_edge[None, :], (C, m)),
                      obstacles, sigma0)                           # (C, m)
        ok = jnp.all(ok, axis=1) & (t_near + m <= 4 * N)           # (C,)

        # ---- pick admissible primitive closest to the target ----
        d_end = jnp.sum((ends[:, :2] - target) ** 2, -1) \
            + np_.w_speed * (ends[:, 2] - v_t) ** 2
        any_ok = jnp.any(ok)
        best = jnp.argmin(jnp.where(ok, d_end, jnp.inf)).astype(jnp.int32)
        seg = jnp.sqrt(jnp.sum((ends[best, :2] - x_near[:2]) ** 2))

        slot = i + 1
        states = states.at[slot].set(jnp.where(any_ok, ends[best], 0.0))
        parent = parent.at[slot].set(near)
        ctrl = ctrl.at[slot].set(prims[best])
        cost = cost.at[slot].set(cost[near] + seg)
        time = time.at[slot].set(t_near + m)
        valid = valid.at[slot].set(any_ok)
        return states, parent, ctrl, cost, time, valid

    states, parent, ctrl, cost, time, valid = jax.lax.fori_loop(
        0, np_.n_iters, grow, (states0, parent0, ctrl0, cost0, time0, valid0))

    # ---- best node: cost-to-come + weighted goal distance ----
    # The root is EXCLUDED from the argmin: picking it would make the whole
    # plan an unchecked constant-speed coast (no edge was ever risk-checked);
    # if no grown node is valid, ``found`` is False and the brake fallback
    # below takes over.
    d_goal = jnp.sqrt(jnp.sum((states[:, :2] - goal) ** 2, -1))
    score = cost + np_.goal_weight * d_goal
    grown = valid & (jnp.arange(Nn) > 0)
    best = jnp.argmin(jnp.where(grown, score, jnp.inf)).astype(jnp.int32)
    found = jnp.any(grown)

    # ---- extract the control tape root -> best (parent-pointer walk) ----
    # Each node v > 0 was reached by holding ctrl[v] over horizon steps
    # [time[v] - m, time[v]); walking best -> root scatters each edge's
    # control into its own slot, so chains deeper than the horizon still
    # execute the FIRST edges from the root, not the tail.
    # Tape slots past the best chain's depth default to the BRAKE primitive
    # (full decel, zero yaw rate), not zero controls: a chain shorter than
    # the horizon must not coast at constant speed through un-risk-checked
    # steps — it brakes, matching the no-path fallback semantics below.
    max_edges = 4 * N // m + 1
    edges0 = jnp.broadcast_to(
        jnp.asarray([p.acc_min, 0.0], dtype), (max_edges, 2))

    def back(c, _):
        edges, node = c
        s = time[node] // m - 1
        edges = jnp.where(
            node > 0,
            edges.at[jnp.maximum(s, 0)].set(ctrl[node]),
            edges,
        )
        return (edges, parent[node]), None

    (edges, _), _ = jax.lax.scan(back, (edges0, best), None, length=Nn)
    u_tape = jnp.repeat(edges, m, axis=0)[:N]            # (N, 2) scales

    # ---- roll out the tape from the ego (exact plant dynamics) ----
    def exec_body(x, us):
        u = jnp.stack([us[0], us[1] * x[2] * p.yawrate_gain])
        xn = dynamics.step(p, x, u)
        return xn, (xn, u)

    _, (Xs, U) = jax.lax.scan(exec_body, ego_state, u_tape)
    X = jnp.concatenate([ego_state[None], Xs], axis=0)

    # emergency brake when no admissible edge exists (frenet fallback
    # semantics: never execute an inadmissible maneuver)
    t = jnp.arange(N + 1, dtype=dtype) * p.timestep
    vb = jnp.maximum(ego_state[2] + p.acc_min * t, 0.0)
    sb = jnp.concatenate([jnp.zeros((1,), dtype),
                          jnp.cumsum(vb[:-1] * p.timestep)])
    yaw0 = ego_state[3]
    X_brake = jnp.stack([ego_state[0] + sb * jnp.cos(yaw0),
                         ego_state[1] + sb * jnp.sin(yaw0),
                         vb, jnp.broadcast_to(yaw0, vb.shape)], axis=-1)
    X = jnp.where(found, X, X_brake)
    dv = jnp.diff(X[:, 2]) / p.timestep
    dyaw = jnp.diff(jnp.unwrap(X[:, 3])) / p.timestep
    U = jnp.where(found, U, dynamics.clamp_control(
        p, X[:-1], jnp.stack([dv, dyaw], axis=-1)))

    n_nodes = jnp.sum(valid.astype(jnp.int32))
    return NRBResult(
        X=X, U=U, ref_x=plan.x_wpts, ref_y=plan.y_fit,
        # finite sentinel on failure: J feeds metric sums downstream
        iterations=n_nodes, J=jnp.where(found, score[best], 1e6),
        lamb=found.astype(dtype),
    )
