"""Experiment runner: closed-loop scenarios with wall-clock planning times.

The analog of the reference's bring-up + record procedure (SURVEY.md §3.4:
CARLA -> bridge -> vehiclepub -> map_engine -> ilqr node -> rosbag record):
one function call.  Two modes:

  * ``run_experiment``: Python-level cycle loop that measures *wall-clock*
    planning time per cycle (the std::chrono timing at
    ilqr_uncertainty_node.cpp:116-124) and streams records to the native
    experiment log (see ``cilqr_tpu.utils.explog``).
  * ``plant.closed_loop_jit``: fully-fused on-device loop for throughput
    (no per-cycle host round trip) — use for batch Monte-Carlo.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cilqr_tpu.models import dynamics, obstacles as obs_mod, solver
from cilqr_tpu.models import reference_path as rp
from cilqr_tpu.sim import plant, scenarios
from cilqr_tpu.utils.params import NoiseParams, SolverParams


def build_scenario_inputs(p: SolverParams, scenario: scenarios.Scenario, dtype=jnp.float32):
    """Planner ellipse obstacles + SAT/costmap pose arrays for a scenario.

    Returns ``(ob, obs_xyyaw, obs_size, obs_mask)``.  ``ob`` is the
    ellipse-barrier pytree the planner consumes and covers the scenario's
    *vehicle* obstacles only.  The pose arrays additionally carry the
    scenario's SAT-only walls (Scenario.walls_xyyaw): they feed the SAT
    collision ground truth and the costmap bbox rasterization, but never
    the planner's ellipse channel — the information asymmetry of the
    CILQR vs CILQR_Base ablation.
    """
    xyyaw = scenario.obstacles_xyyaw
    M = xyyaw.shape[0]
    W = scenario.n_walls
    if M + W > p.max_obstacles:
        raise ValueError(
            f"scenario {scenario.name!r} needs {M + W} obstacle slots, "
            f"max_obstacles={p.max_obstacles}")
    ob = obs_mod.make_static_obstacles(
        p,
        xyyaw[:, :2],
        np.tile(np.asarray(scenario.obstacle_size), (M, 1)),
        xyyaw[:, 2],
        dtype=dtype,
    )
    # SAT/costmap set: vehicles + walls, padded to max_obstacles (far away)
    sat_xyyaw = np.concatenate([xyyaw, scenario.walls_xyyaw], axis=0)
    sat_sizes = np.concatenate(
        [np.tile(np.asarray(scenario.obstacle_size), (M, 1)),
         np.tile(np.asarray(scenario.wall_size), (W, 1))], axis=0)
    pad = p.max_obstacles - M - W
    obs_xyyaw = jnp.asarray(
        np.concatenate([sat_xyyaw, np.full((pad, 3), 1e6)], axis=0), dtype)
    obs_size = jnp.asarray(
        np.concatenate([sat_sizes, np.ones((pad, 2))], axis=0), dtype)
    obs_mask = jnp.asarray(
        np.concatenate([np.ones(M + W), np.zeros(pad)]), dtype)
    return ob, obs_xyyaw, obs_size, obs_mask


#: The algorithm axis of the reference's comparison pipeline
#: (batch_dataprocess.py:458-463: CCNMPC / CILQR / CILQR_Base / Frenet /
#: NRB-RRT) plus the Frenet uncertainty ablations (Frenet/readme.md:1-15).
ALGORITHMS = (
    "cilqr",                # uncertainty-aware CILQR (the paper's method)
    "cilqr_base",           # CILQR without the uncertainty-map term
    "ccnmpc",               # chance-constrained NMPC (tightened ellipses)
    "frenet_origin",        # Frenet lattice, uncertainty ignored
    "frenet_expansion",     # Frenet lattice, chi-sigma inflated obstacles
    "frenet_propagation",   # Frenet lattice, propagated uncertainty costmap
    "nrb_rrt",              # risk-bounded kinodynamic RRT (DR chance bound)
)


def make_plan_step(
    algorithm: str,
    p: SolverParams,
    noise: NoiseParams,
    plan: jnp.ndarray,
    n,
    obstacles=None,
    unc_map=None,
    frenet_params=None,
    cc_params=None,
    nrb_params=None,
):
    """Planner step factory: ``(noisy_state, U_warm, umap=None) ->
    SolveResult-like``.

    One closed-loop/runner code path drives every algorithm in
    ``ALGORITHMS`` — the analog of swapping which planner node is
    launched (SURVEY.md §3.4) while CARLA/vehiclepub stay fixed.  The
    optional third argument carries a per-cycle uncertainty costmap (the
    full-stack loop rebuilds it every tick); algorithms that do not consume
    the costmap ignore it, `cilqr_base` discards it by definition.
    """
    if algorithm == "cilqr":
        return lambda e, u, umap=None: solver.run_step(
            p, plan, n, e, u, obstacles, umap if umap is not None else unc_map)
    if algorithm == "cilqr_base":
        return lambda e, u, umap=None: solver.run_step(
            p, plan, n, e, u, obstacles, None)
    if algorithm == "ccnmpc":
        from cilqr_tpu.models import ccnmpc

        cc = cc_params if cc_params is not None else ccnmpc.CCParams()
        return lambda e, u, umap=None: ccnmpc.run_step(
            p, cc, noise, plan, n, e, u, obstacles)
    if algorithm == "nrb_rrt":
        from cilqr_tpu.models import nrb_rrt

        nrbp = nrb_params if nrb_params is not None else nrb_rrt.NRBParams()
        sig = jnp.asarray([noise.sigma_x, noise.sigma_y, noise.sigma_theta])
        return lambda e, u, umap=None: nrb_rrt.plan_step(
            p, nrbp, plan, n, e, obstacles, sigmas=sig)
    if algorithm.startswith("frenet"):
        from cilqr_tpu.models import frenet

        mode = algorithm.split("_", 1)[1]
        fp = frenet_params if frenet_params is not None else frenet.FrenetParams()
        if fp.mode != mode:
            import dataclasses as _dc

            fp = _dc.replace(fp, mode=mode)
        sig = jnp.asarray([noise.sigma_x, noise.sigma_y, noise.sigma_theta])
        if mode == "propagation":
            return lambda e, u, umap=None: frenet.plan_step(
                p, fp, plan, n, e, obstacles,
                unc_map=umap if umap is not None else unc_map, sigmas=sig)
        return lambda e, u, umap=None: frenet.plan_step(
            p, fp, plan, n, e, obstacles, unc_map=None, sigmas=sig)
    raise ValueError(f"unknown algorithm {algorithm!r}; expected one of {ALGORITHMS}")


def nrb_params_for_scenario(p: SolverParams, scenario, base=None):
    """Corridor-feasible NRB-RRT sampling band for a scenario.

    Restricts lateral target sampling to the scenario's drivable band
    (``Scenario.lat_band`` — the wall inner faces) minus the ego
    half-width + margin: lane-boundary knowledge every planner has from
    the route/map, even when its RISK model is (by design) blind to the
    costmap.  Without this the 2.1 m gauntlet lane collided 10/10 at
    sigma=0 because +-3 m lateral targets sat inside the walls, which
    measured sampler misconfiguration rather than the DR-margin
    wall-blindness the comparison axis (batch_dataprocess.py:458-463) is
    about.  No band (or a degenerate one) keeps ``base`` unchanged."""
    import dataclasses as _dc

    from cilqr_tpu.models import nrb_rrt

    base = base if base is not None else nrb_rrt.NRBParams()
    band = getattr(scenario, "lat_band", None)
    if band is None:
        return base
    half = p.width / 2.0 + base.collision_margin
    lo = max(-base.lat_max, float(band[0]) + half)
    hi = min(base.lat_max, float(band[1]) - half)
    if hi <= lo:
        return base
    return _dc.replace(base, lat_lo=lo, lat_hi=hi)


def run_experiment_batch(
    p: SolverParams,
    noise: NoiseParams,
    plan_np: np.ndarray,
    x0: np.ndarray,
    n_cycles: int,
    scenario: scenarios.Scenario,
    n_runs: int = 10,
    seed: int = 0,
    dtype=jnp.float32,
    algorithm: str = "cilqr",
    unc_map=None,
    frenet_params=None,
    cc_params=None,
    nrb_params=None,
    costmap_params=None,
    global_map=None,
    global_geom=None,
):
    """The reference's 10-run experiment batch (batch_dataprocess.py:386-447,
    471) as ONE device program: ``n_runs`` independently-seeded closed-loop
    runs of a scenario, vmapped over the seed axis.

    With ``costmap_params``/``global_map``/``global_geom`` set, every cycle
    rebuilds the local uncertainty costmap from the global prior (the
    full map_engine + planner pipeline) and feeds it to costmap-consuming
    algorithms (`cilqr`, `frenet_propagation`).

    Returns (record dict with leading axis (n_runs, n_cycles, ...),
    metrics rows ready for ``utils.metrics.export_csv``).
    """
    from cilqr_tpu.utils import metrics as metrics_mod

    plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype)
    ob, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(p, scenario, dtype)
    x0j = jnp.asarray(x0, dtype)
    if algorithm == "nrb_rrt" and nrb_params is None:
        nrb_params = nrb_params_for_scenario(p, scenario)
    plan_step = make_plan_step(
        algorithm, p, noise, plan, n, obstacles=ob, unc_map=unc_map,
        frenet_params=frenet_params, cc_params=cc_params,
        nrb_params=nrb_params,
    )
    full_stack = costmap_params is not None

    def one(key):
        if full_stack:
            return plant.closed_loop_full_stack(
                p, costmap_params, noise, global_map, global_geom, plan, n,
                x0j, key, n_cycles, obstacles=ob,
                obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
                plan_step=plan_step,
            )
        return plant.closed_loop(
            p, noise, plan, n, x0j, key, n_cycles,
            obstacles=ob, obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
            plan_step=plan_step,
        )

    keys = jax.random.split(jax.random.key(seed), n_runs)
    xf, rec = jax.jit(jax.vmap(one))(keys)
    get = rec.__getitem__ if isinstance(rec, dict) else lambda k: getattr(rec, k)

    obs_xy = jnp.asarray(scenario.obstacles_xyyaw[:, :2], dtype)
    per_run = metrics_mod.analyze_batch(get("start_pos"), obs_xy, dt=p.timestep)
    rows = []
    for r in range(n_runs):
        row = metrics_mod.summary_row(
            f"{algorithm}/{scenario.name}/{r}", jax.tree.map(lambda a, r=r: a[r], per_run)
        )
        row["algorithm"] = algorithm
        row["collisions"] = int(np.asarray(get("collided")[r]).sum())
        row["mean_iterations"] = float(np.asarray(get("iterations")[r]).mean())
        rows.append(row)
    return {"final_states": np.asarray(xf), "record": rec}, rows


def run_algorithm_comparison(
    p: SolverParams,
    noise: NoiseParams,
    plan_np: np.ndarray,
    x0: np.ndarray,
    n_cycles: int,
    scenario: scenarios.Scenario,
    algorithms=ALGORITHMS,
    n_runs: int = 10,
    seed: int = 0,
    dtype=jnp.float32,
    unc_map=None,
    costmap_params=None,
    global_map=None,
    global_geom=None,
):
    """The full batch_dataprocess.py comparison (one sheet per algorithm,
    :459-502) in one call: every algorithm runs the same scenario with the
    same seeds, returning {algorithm: (out, rows)} plus a flat row list
    ready for ``metrics.export_csv``.  Pass the costmap/global-map arguments
    to run the full per-cycle map_engine pipeline (required for `cilqr` vs
    `cilqr_base` and `frenet_propagation` vs `frenet_origin` to actually
    differ — without a costmap the uncertainty-consuming variants degrade
    to their base algorithms).
    """
    results = {}
    all_rows = []
    for algo in algorithms:
        out, rows = run_experiment_batch(
            p, noise, plan_np, x0, n_cycles, scenario,
            n_runs=n_runs, seed=seed, dtype=dtype,
            algorithm=algo, unc_map=unc_map,
            costmap_params=costmap_params, global_map=global_map,
            global_geom=global_geom,
        )
        results[algo] = (out, rows)
        all_rows.extend(rows)
    return results, all_rows


def run_experiment(
    p: SolverParams,
    noise: NoiseParams,
    plan_np: np.ndarray,
    x0: np.ndarray,
    n_cycles: int,
    scenario: Optional[scenarios.Scenario] = None,
    unc_map=None,
    seed: int = 0,
    dtype=jnp.float32,
    log=None,
    algorithm: str = "cilqr",
    costmap_params=None,
    global_map=None,
    global_geom=None,
):
    """Closed-loop run with per-cycle wall-clock planning times.

    Returns dict of stacked per-cycle arrays (the /experiment bag payload)
    including measured ``planning_time``; optionally appends every record to
    a native ``cilqr_tpu.utils.explog.ExperimentLog``.

    With ``costmap_params``/``global_map``/``global_geom`` set, every cycle
    rebuilds the local uncertainty costmap from the global prior at the
    true ego pose (the map_engine node on real map data — the CLI's
    ``--map`` path) and feeds it to costmap-consuming algorithms; the
    separate ``costmap_time`` stream records its wall clock (the reference
    times only the ilqr node, ilqr_uncertainty_node.cpp:116-124, so
    ``planning_time`` stays the solver alone).
    """
    plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype)
    if scenario is not None:
        ob, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(p, scenario, dtype)
    else:
        ob = obs_xyyaw = obs_size = obs_mask = None

    solve = jax.jit(make_plan_step(
        algorithm, p, noise, plan, n, obstacles=ob, unc_map=unc_map))
    step = jax.jit(lambda s, u0: dynamics.step(p, s, u0))

    cm_fn = None
    if costmap_params is not None:
        from cilqr_tpu.models import uncertainty as unc_mod
        from cilqr_tpu.ops import costmap as costmap_mod

        if scenario is None:
            raise ValueError("costmap pipeline needs a scenario (obstacle set)")
        M = obs_xyyaw.shape[0]
        sizes = jnp.broadcast_to(obs_size, (M, 2))

        def _cm(state):
            cm = costmap_mod.build_local_costmap(
                costmap_params, global_map, global_geom, plan, n, state,
                obs_xyyaw[:, :2], sizes, obs_xyyaw[:, 2], obs_mask,
            )
            return unc_mod.UncertaintyMap(
                cm.uncertainty_map, cm.geom, cm.origin_xy, cm.origin_yaw)

        cm_fn = jax.jit(_cm)

    key = jax.random.key(seed)
    state = jnp.asarray(x0, dtype)
    U_warm = solver.initial_controls(p, dtype=dtype)

    # warm the jit cache so recorded planning times reflect the steady state
    # (the reference node is likewise warm after its first cycle)
    if cm_fn is not None:
        jax.block_until_ready(solve(state, U_warm, cm_fn(state)))
    else:
        jax.block_until_ready(solve(state, U_warm))

    recs = {k: [] for k in ("start_time", "start_pos", "noisy_pos", "planning_time",
                            "X", "U", "J", "iterations", "collided")}
    if cm_fn is not None:
        recs["costmap_time"] = []
    t_start = time.time()
    for t in range(n_cycles):
        key, k_t = jax.random.split(key)
        noisy = plant.inject_noise(noise, k_t, state)

        if cm_fn is not None:
            t0 = time.perf_counter()
            umap = cm_fn(state)
            jax.block_until_ready(umap)
            recs["costmap_time"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            res = solve(noisy, U_warm, umap)
        else:
            t0 = time.perf_counter()
            res = solve(noisy, U_warm)
        jax.block_until_ready(res)
        planning_time = time.perf_counter() - t0

        if scenario is not None:
            hit = bool(
                plant.check_collisions(p, state, obs_xyyaw, obs_size, obs_mask)
            )
        else:
            hit = False

        recs["start_time"].append(time.time() - t_start)
        recs["start_pos"].append(np.asarray(state))
        recs["noisy_pos"].append(np.asarray(noisy))
        recs["planning_time"].append(planning_time)
        recs["X"].append(np.asarray(res.X))
        recs["U"].append(np.asarray(res.U))
        recs["J"].append(float(res.J))
        recs["iterations"].append(int(res.iterations))
        recs["collided"].append(hit)
        if log is not None:
            log.append(
                start_time=recs["start_time"][-1],
                start_pos=recs["start_pos"][-1],
                planning_time=planning_time,
                X=recs["X"][-1],
                U=recs["U"][-1],
            )

        state = step(state, res.U[0])
        U_warm = res.U

    return {k: np.asarray(v) for k, v in recs.items()}
