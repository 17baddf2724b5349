"""Sigma-sweep campaign: measure WHERE the uncertainty term changes outcomes.

The reference's core experimental claim is that uncertainty-aware CILQR
beats the non-aware baseline under localization noise (the entire purpose
of the missing ``Uncertainty.h`` + ``arbitrary_transformation.cu``;
experiment design ``CILQR/src/ilqr/src/batch_dataprocess.py:459-475``, noise
overrides ``ilqr/launch/Experiment.launch:7-12``).  This module reproduces
that claim *measurably*: a grid of noise levels x algorithms on the
``gauntlet`` scenario (chicane between SAT-only walls — see
``sim.scenarios.make_gauntlet``), with the costmap engine's propagation
sigmas matched to the injected noise exactly as the reference experiment
sets both from the same launch/rqt_reconfigure values.

The algorithm axis covers the reference's full comparison set
(``batch_dataprocess.py:458-463``: CILQR / CILQR_Base / Frenet ablations /
CCNMPC / NRB-RRT).

Compilation model: sigma is a TRACED input — ONE program is compiled per
algorithm (window radius bucketed to the sweep's largest sigma), then every
grid point is a data-only dispatch.  A 10-sigma x 6-algorithm production
grid compiles 6 programs, not 60.

Propagation route: map-consuming cells run the batched full stack, whose
propagation takes the GPU kernel's banded windows (a band plan sized for
every corridor center the route can produce at the bucketed sigmas) on a
GPU, and the full-window XLA propagation elsewhere; both are exact.

Outputs per (sigma, algorithm): collision-run count, min wall clearance,
min obstacle distance, mean speed — the batch_dataprocess.py metric set
plus the wall-clearance column the walled scenario adds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from cilqr_tpu.sim import runner, scenarios
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams

#: The complete reference comparison axis under noise: uncertainty-aware vs
#: blind CILQR, the Frenet propagation-vs-origin ablation, chance-constrained
#: NMPC and risk-bounded RRT (batch_dataprocess.py:458-463).
SWEEP_ALGORITHMS = (
    "cilqr", "cilqr_base", "frenet_origin", "frenet_propagation",
    "ccnmpc", "nrb_rrt",
)

#: Algorithms that consume the per-cycle uncertainty costmap.  The blind
#: ablations discard it BY DEFINITION (the CILQR_Base / Frenet-origin /
#: CCNMPC / NRB-RRT nodes never subscribe to the map topic), so skipping
#: the build for them is faithful; CCNMPC and NRB-RRT instead receive the
#: injected noise sigmas directly (their own uncertainty machinery).
MAP_CONSUMERS = ("cilqr", "frenet_propagation")


def matched_costmap_params(
    cp: CostmapParams, sigma_xy: float, sigma_theta: float
) -> CostmapParams:
    """Costmap propagation sigmas matched to the injected noise, with the
    fixed window radius sized to cover the worst-case 95% ellipse (the
    dynamic EllipseIterator needs no such choice; the static window
    does — ops/costmap.required_window_radius)."""
    from cilqr_tpu.ops import costmap as costmap_mod

    cp = dataclasses.replace(
        cp, sigma_x=sigma_xy, sigma_y=sigma_xy, sigma_theta=sigma_theta)
    r = costmap_mod.required_window_radius(cp, cp.rows, cp.cols)
    if r > cp.window_radius:
        cp = dataclasses.replace(cp, window_radius=r)
    return cp


def wall_clearance(rec, scenario: scenarios.Scenario, ego_width: float,
                   ego_length: float = 4.79):
    """Min distance from the ego side to the nearest wall inner face over a
    recorded batch (runs, cycles, 4).

    Walls are arbitrary OBBs (``Scenario.walls_xyyaw`` carries per-wall yaw)
    — for each wall, the ego center's lateral offset along the wall normal
    minus half wall thickness minus half ego width, counted only while the
    ego is alongside the wall (longitudinal overlap with the wall span,
    grown by half the ego length).  Works unchanged on rotated corridors
    (synthetic h301-class sites), where the former axis-aligned y-band
    formula would silently report garbage.
    """
    if scenario.n_walls == 0:
        return None
    sp = np.asarray(rec["start_pos"])  # (runs, T, 4)
    x, y = sp[..., 0], sp[..., 1]
    L, Wt = float(scenario.wall_size[0]), float(scenario.wall_size[1])
    clear = np.full(x.shape, np.inf)
    for wx, wy, wyaw in np.asarray(scenario.walls_xyyaw, np.float64):
        c, s = np.cos(wyaw), np.sin(wyaw)
        dx, dy = x - wx, y - wy
        lon = c * dx + s * dy
        lat = -s * dx + c * dy
        alongside = np.abs(lon) <= L / 2.0 + ego_length / 2.0
        cw = np.abs(lat) - Wt / 2.0 - ego_width / 2.0
        clear = np.minimum(clear, np.where(alongside, cw, np.inf))
    # runs that never pass a wall contribute nothing (all-inf row)
    return clear.min(axis=-1)  # (runs,)


def make_cell_fn(
    algorithm: str,
    p: SolverParams,
    cp: CostmapParams,
    scenario: scenarios.Scenario,
    plan,
    n,
    x0,
    n_cycles: int,
    n_runs: int,
    global_map,
    global_geom,
    dtype,
    nrb_params=None,
):
    """One jitted sweep cell per algorithm: ``fn(sigma_xy, sigma_theta, key)
    -> record pytree`` with sigma TRACED (noise injection, planner sigmas,
    and costmap propagation sigmas all read it as data).

    ``cp`` must already be window-sized for the largest sigma the cell will
    see (``matched_costmap_params`` at the sweep maximum)."""
    import jax
    import jax.numpy as jnp

    from cilqr_tpu.sim import plant

    ob, obs_xyyaw, obs_size, obs_mask = runner.build_scenario_inputs(
        p, scenario, dtype)
    x0j = jnp.asarray(x0, dtype)
    consumes_map = algorithm in MAP_CONSUMERS
    if algorithm == "nrb_rrt" and nrb_params is None:
        # corridor-feasible lateral sampling (see nrb_params_for_scenario)
        nrb_params = runner.nrb_params_for_scenario(p, scenario)

    band_plan = None
    if consumes_map:
        # bands sized for every corridor center the route can produce at
        # the bucketed (largest) sigmas
        from cilqr_tpu.ops import costmap as costmap_mod

        xr, yr = costmap_mod.corridor_center_bounds(cp, plan, n)
        band_plan = costmap_mod.make_band_plan_bounds(
            cp, cp.rows, cp.cols, xr, yr,
            (cp.sigma_x, cp.sigma_y, cp.sigma_theta))

    def cell(s_xy, s_th, key):
        noise = NoiseParams(s_xy, s_xy, s_th)
        sig3 = jnp.stack([s_xy, s_xy, s_th]).astype(dtype)
        plan_step = runner.make_plan_step(
            algorithm, p, noise, plan, n, obstacles=ob,
            nrb_params=nrb_params)
        run_keys = jax.random.split(key, n_runs)

        if consumes_map:
            # batched full stack with per_run_keys: noise draws are
            # BIT-IDENTICAL to the vmapped single loop the blind cells run,
            # so every (sigma, algorithm) grid column sees the same world
            x0s = jnp.broadcast_to(x0j, (n_runs, 4))
            xf, rec = plant.closed_loop_full_stack_batched(
                p, cp, noise, global_map, global_geom, plan, n,
                x0s, key, n_cycles, obstacles=ob,
                obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
                band_plan=band_plan, costmap_sigmas=sig3,
                plan_step_batched=jax.vmap(plan_step),
                per_run_keys=run_keys,
            )
            # (n_cycles, runs, ...) -> (runs, n_cycles, ...)
            return xf, jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), rec)

        def one(k):
            return plant.closed_loop(
                p, noise, plan, n, x0j, k, n_cycles,
                obstacles=ob, obs_xyyaw=obs_xyyaw, obs_size=obs_size,
                obs_mask=obs_mask, plan_step=plan_step,
            )

        return jax.vmap(one)(run_keys)

    return jax.jit(cell)


def run_sigma_sweep(
    sigmas_xy: Sequence[float],
    algorithms: Sequence[str] = SWEEP_ALGORITHMS,
    scenario: Optional[scenarios.Scenario] = None,
    p: Optional[SolverParams] = None,
    cp: Optional[CostmapParams] = None,
    global_map=None,
    global_geom=None,
    n_runs: int = 10,
    n_cycles: int = 160,
    seed: int = 0,
    sigma_theta_ratio: float = 0.017 / 0.16,
    dtype=None,
    plan=None,
    nrb_params=None,
) -> list[dict]:
    """Run the (sigma x algorithm) grid; returns one result row per cell.

    Every algorithm sees the identical noise draws (same seeds) at each
    sigma; costmap-consuming algorithms get per-cycle propagated costmaps
    whose sigmas match the injected noise (the launch/rqt_reconfigure
    matching of the reference experiment).  ONE program is compiled per
    algorithm — sigma is traced, the costmap window is bucketed to the
    largest sigma in the grid.

    ``plan`` overrides the scenario's default global route (pass the
    rotated route when sweeping a rotated-corridor site).
    """
    import jax
    import jax.numpy as jnp

    from cilqr_tpu.ops import gridmap
    from cilqr_tpu.utils import maps

    if dtype is None:
        dtype = jnp.float32
    sc = scenario if scenario is not None else scenarios.make_gauntlet()
    p = p if p is not None else SolverParams()
    cp = cp if cp is not None else CostmapParams()
    if global_map is None:
        import tempfile

        yaml = maps.make_synthetic_town(tempfile.mkdtemp(prefix="sweep_town_"))
        occ, info = maps.load_map(yaml)
        arr, center = maps.to_gridmap_array(occ, info, unknown_value=100.0)
        global_map = jnp.asarray(arr, dtype)
        global_geom = gridmap.make_geom(
            center, info.resolution, arr.shape[0], arr.shape[1], dtype=dtype)

    if plan is None:
        plan = scenarios.plan_for(
            sc.name if sc.name in scenarios._SCENARIOS else "compare")
    x0 = np.array(sc.start)

    # window bucketed once at the sweep maximum (one compile per algorithm)
    s_max = max(float(s) for s in sigmas_xy)
    cp_max = matched_costmap_params(cp, s_max, s_max * sigma_theta_ratio)

    from cilqr_tpu.models import reference_path as rp

    planj, n = rp.pad_global_plan(p, np.asarray(plan), dtype=dtype)

    rows = []
    for algo in algorithms:
        fn = make_cell_fn(
            algo, p, cp_max, sc, planj, n, x0, n_cycles, n_runs,
            global_map, global_geom, dtype,
            nrb_params=nrb_params)
        for s_xy in sigmas_xy:
            s_th = s_xy * sigma_theta_ratio
            key = jax.random.key(seed)
            _, rec = fn(jnp.asarray(s_xy, dtype), jnp.asarray(s_th, dtype), key)
            rows.append(
                summarize_cell(rec, sc, p, algo, float(s_xy), float(s_th),
                               n_runs))
    rows.sort(key=lambda r: (r["sigma_xy"], SWEEP_ALGORITHMS.index(r["algorithm"])
                             if r["algorithm"] in SWEEP_ALGORITHMS else 99))
    return rows


def summarize_cell(rec, sc: scenarios.Scenario, p: SolverParams,
                   algo: str, s_xy: float, s_th: float, n_runs: int) -> dict:
    """One result row from a (runs, cycles, ...) record pytree."""
    from cilqr_tpu.utils import metrics as metrics_mod

    import jax.numpy as jnp

    get = rec.__getitem__ if isinstance(rec, dict) else lambda k: getattr(rec, k)
    collided = np.asarray(get("collided"))  # (runs, T)
    obs_xy = jnp.asarray(sc.obstacles_xyyaw[:, :2])
    per_run = metrics_mod.analyze_batch(
        jnp.asarray(np.asarray(get("start_pos"))), obs_xy, dt=p.timestep)
    wc = wall_clearance(
        rec if isinstance(rec, dict) else rec._asdict(), sc, p.width,
        ego_length=p.length)
    run_collided = collided.sum(axis=-1) > 0
    row = {
        "sigma_xy": float(s_xy),
        "sigma_theta": round(float(s_th), 4),
        "algorithm": algo,
        "collision_runs": int(run_collided.sum()),
        "n_runs": n_runs,
        # per-run bitmask: worlds are shared across algorithms at each
        # sigma (identical noise draws), so paired (McNemar-style)
        # comparisons across algorithm rows are exact
        "collided_mask": "".join("1" if c else "0" for c in run_collided),
        "velocity_mean": round(float(np.mean(per_run["velocity"].mean)), 3),
        "min_obstacle_distance": round(
            float(np.min(per_run["distance_to_obstacles"].min)), 3),
        "mean_jerk": round(float(np.mean(per_run["mean_jerk"])), 4),
    }
    if wc is not None:
        # drop runs never longitudinally alongside any wall (+inf rows) —
        # round()ing them straight in would emit the non-standard JSON
        # token Infinity (advisor r3).  CONTRACT (advisor r4): when EVERY
        # run is +inf the keys are still present, as float NaN, so numpy
        # predicates on rows degrade gracefully (np.isfinite/np.mean
        # propagate NaN instead of raising TypeError on None); the JSON
        # writer (`rows_to_json`) serializes NaN as a standard null.
        wcf = wc[np.isfinite(wc)]
        row["min_wall_clearance"] = (
            round(float(wcf.min()), 3) if wcf.size else float("nan"))
        row["mean_min_wall_clearance"] = (
            round(float(wcf.mean()), 3) if wcf.size else float("nan"))
    return row


def rows_to_json(rows: list[dict]) -> str:
    """Serialize sweep rows to STRICT JSON (indent=2).

    Row floats may be NaN (the all-inf wall-clearance contract above);
    ``json.dumps`` would emit the non-standard ``NaN`` token, so map NaN
    to null here — the one sanctioned write path for sweep rows."""
    import json

    def _clean(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        return v

    return json.dumps(
        [{k: _clean(v) for k, v in r.items()} for r in rows], indent=2)


def paired_sign_test(row_a: dict, row_b: dict) -> dict:
    """Exact two-sided sign test on the paired per-run collision outcomes
    of two sweep rows that shared their noise worlds.

    Every algorithm column at a given sigma runs the IDENTICAL noise draws
    (same per-run keys), so the two ``collided_mask`` strings are paired
    observations; the discordant counts (worlds that killed only A / only
    B) carry all the comparative information (McNemar).  Returns the
    counts and the exact binomial two-sided p-value.  This is how the
    docs/BASELINES.md n=50 significance statements are computed.
    """
    from math import comb

    a, b = row_a["collided_mask"], row_b["collided_mask"]
    if len(a) != len(b):
        raise ValueError("rows have different run counts")
    only_a = sum(1 for x, y in zip(a, b) if x == "1" and y == "0")
    only_b = sum(1 for x, y in zip(a, b) if x == "0" and y == "1")
    both = sum(1 for x, y in zip(a, b) if x == "1" and y == "1")
    n = only_a + only_b
    if n == 0:
        p = 1.0
    else:
        tail = sum(comb(n, k) for k in range(0, min(only_a, only_b) + 1))
        p = min(1.0, 2.0 * tail / 2.0**n)
    return {"only_a": only_a, "only_b": only_b, "both": both,
            "n_discordant": n, "p_value": p}


def format_table(rows: list[dict]) -> str:
    """Markdown table for docs/BASELINES.md."""
    cols = ["sigma_xy", "algorithm", "collision_runs", "min_wall_clearance",
            "mean_min_wall_clearance", "min_obstacle_distance",
            "velocity_mean", "mean_jerk"]
    have = [c for c in cols if any(c in r for r in rows)]
    out = ["| " + " | ".join(have) + " |",
           "|" + "|".join("---" for _ in have) + "|"]
    for r in rows:
        out.append("| " + " | ".join(
            "" if r.get(c) is None
            or (isinstance(r[c], float) and not np.isfinite(r[c]))
            else str(r[c]) for c in have) + " |")
    return "\n".join(out)
