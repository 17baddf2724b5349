"""Closed-loop plant: the pure-JAX replacement for CARLA + ros-bridge.

Replaces the reference's simulation stack (CARLA server, carla-ros-bridge,
vehiclepub spawner) for benchmarking and regression tests:

  * plant dynamics  = the same kinematic bicycle the planner assumes
    (receding-horizon application of U[0], ilqr_uncertainty_node.cpp:129)
  * localization noise = per-cycle N(0, sigma) on x/y/theta
    (ilqr_uncertainty_node.cpp:82-110 — deliberately a *feature*)
  * collision ground truth = SAT OBB checks against every obstacle
    (Experiment.cpp + the CARLA collision sensors, main.py:65-75)
  * experiment record = per-cycle (start_pos, X, U, J, iters) streams, the
    /experiment topic payload (vehiclepub/msg/Experiment.msg)

The whole closed loop is one ``lax.scan`` -> jittable, vmappable over
scenario batches, shardable over meshes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cilqr_tpu.models import dynamics, solver
from cilqr_tpu.sim import collision
from cilqr_tpu.utils.params import NoiseParams, SolverParams


class AckermannCmd(NamedTuple):
    """The /carla/ego_vehicle/ackermann_cmd payload
    (ilqr_uncertainty_node.cpp:229-238)."""

    steering_angle: jax.Array        # = yaw-rate control (reference quirk)
    steering_angle_velocity: jax.Array
    speed: jax.Array                 # = current speed + accel
    acceleration: jax.Array
    jerk: jax.Array


def to_ackermann(speed: jax.Array, u0: jax.Array) -> AckermannCmd:
    """publishVehicleCmd semantics: speed+accel as target speed, the yaw-rate
    control published in the steering_angle field."""
    z = jnp.zeros_like(speed)
    return AckermannCmd(u0[1], z, speed + u0[0], z, z)


class ExperimentRecord(NamedTuple):
    """Per-cycle /experiment payload (+ solver telemetry)."""

    start_pos: jax.Array   # (T, 4) true ego state at cycle start
    noisy_pos: jax.Array   # (T, 4) state fed to the planner
    X: jax.Array           # (T, N+1, 4) planned trajectories
    U: jax.Array           # (T, N, 2) planned controls
    J: jax.Array           # (T,)
    iterations: jax.Array  # (T,)
    collided: jax.Array    # (T,) any-obstacle SAT hit at cycle start


def inject_noise(noise: NoiseParams, key: jax.Array, state: jax.Array) -> jax.Array:
    """N(0, sigma) on x, y, theta (ilqr_uncertainty_node.cpp:82-110)."""
    r = jax.random.normal(key, (3,), dtype=state.dtype)
    return state.at[0].add(noise.sigma_x * r[0]).at[1].add(noise.sigma_y * r[1]).at[3].add(
        noise.sigma_theta * r[2]
    )


def check_collisions(p: SolverParams, state, obs_xyyaw, obs_size, obs_mask):
    """Any SAT overlap between the ego footprint and a live obstacle.

    ``obs_size`` is (2,) shared or (M, 2) per obstacle."""
    ego = (state[0], state[1], state[3], jnp.asarray(p.length, state.dtype),
           jnp.asarray(p.width, state.dtype))
    M = obs_xyyaw.shape[0]
    sizes = jnp.broadcast_to(obs_size, (M, 2))

    def one(o, sz, m):
        hit = collision.is_collision(ego, (o[0], o[1], o[2], sz[0], sz[1]))
        return jnp.logical_and(hit, m > 0)

    return jnp.any(jax.vmap(one)(obs_xyyaw, sizes, obs_mask))


def closed_loop(
    p: SolverParams,
    noise: NoiseParams,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    x0: jax.Array,
    key: jax.Array,
    n_cycles: int,
    obstacles=None,
    unc_map=None,
    obs_xyyaw: Optional[jax.Array] = None,
    obs_size: Optional[jax.Array] = None,
    obs_mask: Optional[jax.Array] = None,
    plan_step=None,
) -> tuple[jax.Array, ExperimentRecord]:
    """Run ``n_cycles`` plan->act cycles (apply U[0], receding horizon).

    Returns (final_state, ExperimentRecord).  The system bring-up sequence
    of SURVEY.md §3.4 collapses into this one function: no processes, no
    topics, one differentiable program.

    ``plan_step(noisy_state, U_warm) -> SolveResult-like`` swaps in a
    different planner (Frenet lattice, CCNMPC, ...); default is the CILQR
    solver.  The result must expose .X/.U/.J/.iterations.
    """
    dtype = x0.dtype
    U0 = solver.initial_controls(p, dtype=dtype)
    have_obs = obs_xyyaw is not None
    if plan_step is None:
        def plan_step(noisy, U_warm):
            return solver.run_step(p, plan_xy, plan_n, noisy, U_warm, obstacles, unc_map)

    def cycle(carry, key_t):
        state, U_warm = carry
        noisy = inject_noise(noise, key_t, state)
        res = plan_step(noisy, U_warm)
        if have_obs:
            hit = check_collisions(p, state, obs_xyyaw, obs_size, obs_mask)
        else:
            hit = jnp.asarray(False)
        # apply only the first control (ilqr_uncertainty_node.cpp:129)
        nxt = dynamics.step(p, state, res.U[0])
        rec = (state, noisy, res.X, res.U, res.J, res.iterations, hit)
        return (nxt, res.U), rec

    keys = jax.random.split(key, n_cycles)
    (xf, _), recs = jax.lax.scan(cycle, (x0, U0), keys)
    return xf, ExperimentRecord(*recs)


@partial(jax.jit, static_argnums=(0, 1, 6))
def closed_loop_jit(p, noise, plan_xy, plan_n, x0, key, n_cycles,
                    obstacles=None, unc_map=None,
                    obs_xyyaw=None, obs_size=None, obs_mask=None):
    return closed_loop(p, noise, plan_xy, plan_n, x0, key, n_cycles,
                       obstacles, unc_map, obs_xyyaw, obs_size, obs_mask)


def closed_loop_full_stack(
    p: SolverParams,
    cp,
    noise: NoiseParams,
    global_map: jax.Array,
    global_geom,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    x0: jax.Array,
    key: jax.Array,
    n_cycles: int,
    obstacles=None,
    obs_xyyaw: Optional[jax.Array] = None,
    obs_size: Optional[jax.Array] = None,
    obs_mask: Optional[jax.Array] = None,
    plan_step=None,
    percept=None,
    costmap_sigmas=None,
):
    """The complete two-node pipeline in one scan: every cycle rebuilds the
    local uncertainty costmap from the global prior (the map_engine node,
    local_costmap.cpp:172-310) and feeds it to the planner (the ilqr node).

    The costmap is built at the *true* ego pose (the costmap node consumes
    raw odometry) while the solver sees the *noisy* pose (the planner node
    injects localization noise, ilqr_uncertainty_node.cpp:82-110) — exactly
    the reference's information flow.

    ``plan_step(noisy_state, U_warm, umap) -> SolveResult-like`` swaps in a
    different planner receiving the per-cycle uncertainty map; default is
    the CILQR solver.

    ``percept`` (``sim.perception.PerceptionSim``) activates the perception
    channel: obstacle ``percept.obs_index`` moves at ``percept.vel`` and is
    REMOVED from the bounding-box rasterization — each cycle the camera sim
    produces a noisy cell-space bbox of its true pose
    (``perception.bbox_measurement``), the constant-velocity KF smooths it
    (``models.tracker.step``, the costmap node's filter at
    local_costmap.cpp:139-159,352-380), and the *tracked* box is rasterized
    into ``semantic_lidar_map`` and overrides the vehicle map the
    propagation consumes.  SAT collision ground truth still uses the true
    moving pose.

    ``costmap_sigmas`` (3,) feeds the propagation sigmas as a TRACED value
    (sigma-sweep grids compile one program per algorithm); None keeps the
    static ``cp`` sigmas.
    """
    from cilqr_tpu.models import uncertainty as unc_mod
    from cilqr_tpu.ops import costmap as costmap_mod, gridmap

    dtype = x0.dtype
    U0 = solver.initial_controls(p, dtype=dtype)
    if plan_step is None:
        def plan_step(noisy, U_warm, umap):
            return solver.run_step(p, plan_xy, plan_n, noisy, U_warm, obstacles, umap)
    M = obs_xyyaw.shape[0] if obs_xyyaw is not None else 0
    if M:
        sizes = jnp.broadcast_to(obs_size, (M, 2)) if obs_size.ndim == 1 else obs_size
    else:
        obs_xyyaw = jnp.full((1, 3), 1e6, dtype)
        sizes = jnp.ones((1, 2), dtype)
        obs_mask = jnp.zeros((1,), dtype)

    if percept is not None:
        from cilqr_tpu.models import tracker
        from cilqr_tpu.sim import perception

        pi = percept.obs_index
        if not (0 <= pi < M):
            raise ValueError(f"percept.obs_index={pi} out of range for {M} obstacles")
        # camera-only channel: no bbox rasterization of the perceived obstacle
        raster_mask = obs_mask.at[pi].set(0.0)
        kf0 = tracker.init(dtype=dtype)

    def cycle(carry, inp):
        key_t, t = inp
        if percept is None:
            state, U_warm = carry
            obs_now = obs_xyyaw
            tracked_box = tracked_valid = None
            cm_raster_mask = obs_mask
        else:
            state, U_warm, kf = carry
            shift = (t.astype(dtype) * p.timestep) * percept.vel
            obs_now = obs_xyyaw.at[pi, :2].add(shift)
            cm_raster_mask = raster_mask
            # the camera measures in the tick's vehicle-frame grid
            center, _, _ = costmap_mod.corridor_geometry(
                cp, plan_xy, plan_n, state[:2], state[3])
            geom_t = gridmap.GridGeom(
                center.astype(dtype),
                jnp.asarray(cp.resolution, dtype),
                jnp.asarray([cp.rows * cp.resolution, cp.cols * cp.resolution], dtype),
            )
            # The camera key is DERIVED from the cycle key (fold_in), never
            # split off it: the localization-noise stream is bit-identical
            # with percept on/off, and matches the batched loop's per-lane
            # rule (camera key = fold_in(noise key, 7)).
            k_cam = jax.random.fold_in(key_t, 7)
            z, z_valid = perception.bbox_measurement(
                cp, geom_t, state[:2], state[3],
                obs_now[pi, :2], sizes[pi], obs_now[pi, 2],
                key=k_cam, sigma=percept.bbox_sigma,
            )
            kf, tracked_box = tracker.step(kf, z, z_valid)
            tracked_valid = z_valid

        cm = costmap_mod.build_local_costmap(
            cp, global_map, global_geom, plan_xy, plan_n, state,
            obs_now[:, :2], sizes, obs_now[:, 2], cm_raster_mask,
            tracked_box=tracked_box, tracked_valid=tracked_valid,
            sigmas=costmap_sigmas,
        )
        umap = unc_mod.UncertaintyMap(
            cm.uncertainty_map, cm.geom, cm.origin_xy, cm.origin_yaw
        )
        noisy = inject_noise(noise, key_t, state)
        res = plan_step(noisy, U_warm, umap)
        if M:
            hit = check_collisions(p, state, obs_now, obs_size, obs_mask)
        else:
            hit = jnp.asarray(False)
        nxt = dynamics.step(p, state, res.U[0])
        rec = {
            "start_pos": state,
            "noisy_pos": noisy,
            "J": res.J,
            "iterations": res.iterations,
            "collided": hit,
            "uncertainty_max": jnp.max(cm.uncertainty_map),
        }
        if percept is None:
            return (nxt, res.U), rec
        rec.update(
            tracked_box=tracked_box,
            bbox_meas=z,
            bbox_valid=z_valid,
            semantic_max=jnp.max(cm.semantic_lidar_map),
            obs_pos=obs_now[pi, :2],
        )
        return (nxt, res.U, kf), rec

    keys = jax.random.split(key, n_cycles)
    ts = jnp.arange(n_cycles)
    carry0 = (x0, U0) if percept is None else (x0, U0, kf0)
    (xf, *_), recs = jax.lax.scan(cycle, carry0, (keys, ts))
    return xf, recs


def closed_loop_batched(
    p: SolverParams,
    noise: NoiseParams,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    x0s: jax.Array,
    key: jax.Array,
    n_cycles: int,
    obstacles=None,
    unc_map=None,
    obs_xyyaw: Optional[jax.Array] = None,
    obs_size: Optional[jax.Array] = None,
    obs_mask: Optional[jax.Array] = None,
):
    """Monte-Carlo closed loop: every plan->act cycle solves the whole
    (B, ...) scenario batch through ``solver_batched.run_steps_batched``
    (any B; the route follows the backend and the input).

    Returns (final states (B, 4), per-cycle record pytree with leading axis
    (n_cycles, B, ...)).  This is the production serving shape: thousands of
    vehicles replanning in lockstep on one device.
    """
    from cilqr_tpu.models import solver_batched

    B = x0s.shape[0]
    dtype = x0s.dtype
    U0 = jnp.broadcast_to(
        solver.initial_controls(p, dtype=dtype), (B, p.horizon, 2)
    )
    have_obs = obs_xyyaw is not None

    def cycle(carry, key_t):
        states, U_warm = carry
        keys = jax.random.split(key_t, B)
        noisy = jax.vmap(lambda k, s: inject_noise(noise, k, s))(keys, states)
        res = solver_batched.run_steps_batched(
            p, plan_xy, plan_n, noisy, U_warm, obstacles, unc_map
        )
        if have_obs:
            hits = jax.vmap(
                lambda s: check_collisions(p, s, obs_xyyaw, obs_size, obs_mask)
            )(states)
        else:
            hits = jnp.zeros((B,), bool)
        nxt = dynamics.step(p, states, res.U[:, 0])
        rec = (states, noisy, res.J, res.iterations, res.failed, hits)
        return (nxt, res.U), rec

    keys = jax.random.split(key, n_cycles)
    (xf, _), (sp, npos, J, iters, failed, hit) = jax.lax.scan(
        cycle, (x0s, U0), keys)
    return xf, {
        "start_pos": sp,
        "noisy_pos": npos,
        "J": J,
        "iterations": iters,
        "failed": failed,
        "collided": hit,
    }


def closed_loop_full_stack_batched(
    p: SolverParams,
    cp,
    noise: NoiseParams,
    global_map: jax.Array,
    global_geom,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    x0s: jax.Array,
    key: jax.Array,
    n_cycles: int,
    obstacles=None,
    obs_xyyaw: Optional[jax.Array] = None,
    obs_size: Optional[jax.Array] = None,
    obs_mask: Optional[jax.Array] = None,
    band_plan=None,
    percept=None,
    costmap_sigmas=None,
    plan_step_batched=None,
    per_run_keys=None,
):
    """The COMPLETE reference pipeline, batched: every plan->act cycle,
    every scenario rebuilds its own vehicle-frame uncertainty costmap from
    the shared global prior (batched propagation, per-scenario frames) and
    replans against its own map through ``solver_batched.run_steps_batched``.

    ``percept`` activates the per-scenario camera -> KF ->
    ``semantic_lidar_map`` channel exactly as in ``closed_loop_full_stack``
    (every scenario runs its own tracker; the perceived obstacle is
    camera-only).

    Same information flow as ``closed_loop_full_stack`` per scenario
    (costmap at the true pose, solver at the noisy pose), for any B.  This
    is the scaled replacement for N parallel CARLA+ROS stacks: thousands of
    vehicles, each with its own map engine and planner node, in one jitted
    scan on one device.

    ``plan_step_batched(noisy_states, U_warm, umaps) -> batched
    SolveResult-like`` swaps in a different batched planner (e.g. a
    vmapped Frenet/CCNMPC step); default is the batched CILQR solver.

    ``per_run_keys`` (B,) makes the noise/camera streams BIT-IDENTICAL to
    ``vmap(closed_loop*)`` over those keys (each lane's cycle keys are
    ``split(per_run_keys[i], n_cycles)``, the single-loop discipline) — the
    sigma sweep uses this so batched costmap-consuming cells see exactly
    the draws the blind single-loop cells see.  Default (None): the cycle
    key is split per lane (the serving/bench discipline).
    """
    from cilqr_tpu.models import solver_batched, uncertainty as unc_mod
    from cilqr_tpu.ops import costmap as costmap_mod

    B = x0s.shape[0]
    dtype = x0s.dtype
    U0 = jnp.broadcast_to(
        solver.initial_controls(p, dtype=dtype), (B, p.horizon, 2)
    )
    M = obs_xyyaw.shape[0] if obs_xyyaw is not None else 0
    if M:
        sizes = jnp.broadcast_to(obs_size, (M, 2)) if obs_size.ndim == 1 else obs_size
    else:
        obs_xyyaw = jnp.full((1, 3), 1e6, dtype)
        sizes = jnp.ones((1, 2), dtype)
        obs_mask = jnp.zeros((1,), dtype)

    if percept is not None:
        from cilqr_tpu.models import tracker
        from cilqr_tpu.sim import perception
        from cilqr_tpu.ops import gridmap

        pi = percept.obs_index
        if not (0 <= pi < M):
            raise ValueError(f"percept.obs_index={pi} out of range for {M} obstacles")
        raster_mask = obs_mask.at[pi].set(0.0)
        kf0 = jax.vmap(lambda _: tracker.init(dtype=dtype))(jnp.arange(B))

    def cycle(carry, inp):
        key_t, t = inp
        if per_run_keys is None:
            lane_keys = jax.random.split(key_t, B)  # one noise key per lane
        else:
            lane_keys = key_t  # already (B,) per-lane keys for this cycle
        if percept is None:
            states, U_warm = carry
            obs_now = obs_xyyaw
            boxes = valid = None
            cm_raster_mask = obs_mask
        else:
            states, U_warm, kf = carry
            shift = (t.astype(dtype) * p.timestep) * percept.vel
            obs_now = obs_xyyaw.at[pi, :2].add(shift)
            cm_raster_mask = raster_mask

            def measure(s, k):
                center, _, _ = costmap_mod.corridor_geometry(
                    cp, plan_xy, plan_n, s[:2], s[3])
                g = gridmap.GridGeom(
                    center.astype(dtype),
                    jnp.asarray(cp.resolution, dtype),
                    jnp.asarray(
                        [cp.rows * cp.resolution, cp.cols * cp.resolution], dtype),
                )
                return perception.bbox_measurement(
                    cp, g, s[:2], s[3], obs_now[pi, :2], sizes[pi],
                    obs_now[pi, 2], key=k, sigma=percept.bbox_sigma)

            # same rule as the single loop: camera key = fold_in(noise key, 7)
            # per lane, so percept on/off never perturbs the noise stream
            k_cams = jax.vmap(lambda k: jax.random.fold_in(k, 7))(lane_keys)
            zs, valid = jax.vmap(measure)(states, k_cams)
            kf, boxes = jax.vmap(tracker.step)(kf, zs, valid)

        cms = costmap_mod.build_local_costmap_batched(
            cp, global_map, global_geom, plan_xy, plan_n, states,
            obs_now[:, :2], sizes, obs_now[:, 2], cm_raster_mask,
            band_plan=band_plan,
            tracked_boxes=boxes, tracked_valid=valid,
            sigmas=costmap_sigmas,
        )
        umaps = unc_mod.UncertaintyMap(
            cms.uncertainty_map, cms.geom, cms.origin_xy, cms.origin_yaw
        )
        noisy = jax.vmap(lambda k, s: inject_noise(noise, k, s))(lane_keys, states)
        if plan_step_batched is not None:
            res = plan_step_batched(noisy, U_warm, umaps)
        else:
            res = solver_batched.run_steps_batched(
                p, plan_xy, plan_n, noisy, U_warm, obstacles, umaps,
            )
        if M:
            hits = jax.vmap(
                lambda s: check_collisions(p, s, obs_now, obs_size, obs_mask)
            )(states)
        else:
            hits = jnp.zeros((B,), bool)
        nxt = dynamics.step(p, states, res.U[:, 0].astype(dtype))
        rec = {
            "start_pos": states,
            "noisy_pos": noisy,
            "J": res.J,
            "iterations": res.iterations,
            "collided": hits,
            "uncertainty_max": jnp.max(cms.uncertainty_map, axis=(1, 2)),
        }
        if plan_step_batched is None:
            rec["failed"] = res.failed
        # the GPU kernel solves in f32; keep the warm-start carry in the
        # caller's dtype so the scan carry is type-stable
        if percept is None:
            return (nxt.astype(dtype), res.U.astype(dtype)), rec
        rec.update(
            tracked_box=boxes,
            bbox_valid=valid,
            semantic_max=jnp.max(cms.semantic_lidar_map, axis=(1, 2)),
        )
        return (nxt.astype(dtype), res.U.astype(dtype), kf), rec

    if per_run_keys is None:
        keys = jax.random.split(key, n_cycles)
    else:
        # (T, B): lane i's cycle-t key == split(per_run_keys[i], T)[t],
        # the exact key the single loop would draw for that run
        keys = jnp.swapaxes(
            jax.vmap(lambda k: jax.random.split(k, n_cycles))(per_run_keys),
            0, 1)
    carry0 = (x0s, U0) if percept is None else (x0s, U0, kf0)
    (xf, *_), recs = jax.lax.scan(cycle, carry0, (keys, jnp.arange(n_cycles)))
    return xf, recs
