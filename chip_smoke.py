"""Smoke run of the planner on one GPU, through the entry points a user calls.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded campaign only

Phases (one process; no phase catches its own failure):

0. device check — JAX's devices, the card's name and power limit
   (``nvidia-smi``); exits non-zero unless JAX runs on a GPU;
1. compile each program at full width, on the route the backend picks and
   on the plain XLA route, and print its memory analysis;
2. run and compare at full width: the batched solve (B=32768, N=50, full
   constraints), the Monte-Carlo pipeline (B=8192), the full-stack closed
   loop (B=8192, 5 cycles), the shared-world closed loop (B=32768, 10
   cycles) and ``solver.run_step_jit`` twice.  Outputs must be finite, LM
   iterations in 1..max_iterations and uncertainty maps in [0, 100].  Every
   lane of the GPU route is compared with the XLA route in float32 (the two
   differ in summation order only), and a sample of lanes, with every lane
   that stopped on non-finite gains, with the XLA route in float64;
3. time each hand-written kernel and its pipeline against XLA's plain route,
   then run the GPU test tier (``pytest -m gpu``) in this process.

The last line printed is ``{"ok": true, "device": {...}}``.

``--four-cards`` runs ``make_sharded_monte_carlo`` and
``make_sharded_full_stack`` on a 1-D mesh over four cards, and the
per-shard unsharded runs they must equal.

Closed loops run with zero localization noise: the noise draws of a lane
depend on the batch size and dtype, so only noise-free lanes can be
compared one by one with a float64 subset.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np

#: full widths (the cells ROADMAP S1 names)
B_SOLVE, B_MC, B_FS, B_CL = 32768, 8192, 8192, 32768
CYCLES_FS, CYCLES_CL = 5, 10
#: lanes compared with float64: N_REF spread over the batch, plus up to
#: N_REF_FAILED of the lanes that stopped on non-finite gains
N_REF, N_REF_FAILED = 64, 16
#: lanes per program of the LM kernel (ops/lm_pallas.BLOCK)
BLOCK = 64

#: tolerances, each with its reason (printed beside every comparison)
TOL = {
    # --- the GPU route vs the XLA route in float32, every lane ---------
    "route_du": (2e-3, "max head |dU| of a lane equal on the GPU and the "
                       "float32 XLA route; they differ in summation order"),
    "route_dj": (2e-3, "max relative |dJ| of a lane equal on both float32 "
                       "routes (for closed loops: the first cycle's solve)"),
    "route_dx": (1e-3, "closed loops: max |dx| [m] of final positions of a "
                       "lane equal on both float32 routes"),
    # a lane near a fork (passing an obstacle on one side or the other, or
    # stopping one LM iteration earlier) settles apart on two summation
    # orders; such lanes are counted, not bounded
    "forks": (5e-3, "share of solves apart between the two float32 routes"),
    "block_forks": (4, "solves apart in one 64-lane program of the kernel; "
                       "a fault in one program puts all 64 apart"),
    # closed loops fork more: the full stack's maps are rough (a random
    # prior), and after 5-10 cycles a fork in any cycle moves the vehicle,
    # so final positions are held to the float64 limit, loop_dx
    "loop_forks": (0.03, "share of closed-loop lanes apart on the two float32 "
                         "routes: first-cycle J beyond route_dj, or final "
                         "positions beyond loop_dx"),
    "loop_block_forks": (10, "closed-loop lanes apart in one 64-lane program"),
    # --- the GPU route vs the XLA route in float64, sampled lanes ------
    # receding-horizon MPC applies the head of the plan; float32 rounding
    # grows along the 50-step horizon
    "head_du": (2e-2, "max |dU| over the first 10 steps of a lane that "
                      "agrees with float64"),
    "rel_dj": (2e-2, "max relative |dJ| of a lane that agrees with float64; "
                     "J sums the float32 tracking and control terms"),
    "loop_dx": (5e-2, "max |dx| [m] of closed-loop positions of a lane that "
                      "agrees with float64 after all cycles"),
    "agree": (0.9, "share of sampled lanes that agree with float64; the rest "
                   "sit at a fork in float32 on both routes"),
    # --- propagation ---------------------------------------------------
    "unc": (1e-3, "max |d map| of the propagation kernel vs the float32 XLA "
                  "reference, every map; 1/sigma products vs divisions"),
}


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    """Every check of the script ends here: AssertionError unless ``cond``."""
    if not cond:
        raise AssertionError(msg)


def device_check() -> dict:
    """Phase 0: JAX's devices; SystemExit unless the first is a GPU."""
    import jax

    from cilqr_tpu.utils.device import require_gpu

    log("jax.devices():", jax.devices())
    dev = require_gpu()
    log("platform:", dev["platform"], "| device_kind:", dev["kind"],
        "| count:", dev["count"])
    return dev


@contextlib.contextmanager
def xla_only():
    """Force the plain XLA route in both route choices while a program is
    traced (``compile_program`` and ``fresh`` trace a new function, so a
    trace cached on the GPU route is never reused)."""
    from cilqr_tpu.models import solver_batched
    from cilqr_tpu.ops import costmap

    saved = solver_batched.kernel_route, costmap.kernel_route
    solver_batched.kernel_route = lambda *a, **k: False
    costmap.kernel_route = lambda *a, **k: False
    try:
        yield
    finally:
        solver_batched.kernel_route, costmap.kernel_route = saved


def fresh(fn):
    """``jax.jit`` of a new function that calls ``fn``: jit caches traces
    by function, and a trace taken on one route must not serve another."""
    import jax

    return jax.jit(lambda *a: fn(*a))


def compile_program(name, fn, *args):
    """Phase 1: AOT-compile ``fn`` (traced afresh) and print its memory
    analysis."""
    t0 = time.perf_counter()
    compiled = fresh(fn).lower(*args).compile()
    log(f"[compile] {name}: {time.perf_counter() - t0:.1f} s;",
        compiled.memory_analysis())
    return compiled


def _limit(key, value, at_least=False):
    lim, why = TOL[key]
    log(f"    {key} = {value:.3e} ({'at least' if at_least else 'limit'} "
        f"{lim:g}: {why})")
    require(value >= lim if at_least else value <= lim, f"{key}: {value} vs {lim}")


def _quantiles(label, a):
    q = np.quantile(a, [0.5, 0.9, 0.99, 0.999]) if a.size else [np.nan] * 4
    log(f"    {label}: p50 {q[0]:.2e}, p90 {q[1]:.2e}, p99 {q[2]:.2e}, "
        f"p99.9 {q[3]:.2e}, max {a.max():.2e}")


def check_solve(name, res, max_it):
    """Finite outputs and iterations in range; returns the lanes that
    stopped on non-finite gains."""
    X, U, J, it = (np.asarray(a) for a in (res.X, res.U, res.J, res.iterations))
    failed = np.asarray(res.failed)
    log(f"[check] {name}: iterations {it.min()}..{it.max()} (mean "
        f"{it.mean():.2f}); {failed.sum()} lanes stopped on non-finite gains "
        f"{np.flatnonzero(failed)[:8].tolist()}")
    require(np.isfinite(X).all() and np.isfinite(U).all() and np.isfinite(J).all(),
            f"{name}: non-finite outputs")
    require(it.min() >= 1 and it.max() <= max_it, f"{name}: iterations")
    return failed


def check_loop(name, xf, rec, max_it):
    """Closed-loop record: finite states, iterations in range, maps in
    [0, 100] (when the loop builds maps).  Returns the lanes that stopped on
    non-finite gains in any cycle."""
    xf, it = np.asarray(xf), np.asarray(rec["iterations"])
    per_cycle = np.asarray(rec["failed"])
    failed = per_cycle.any(axis=0)
    bad = np.flatnonzero(~np.isfinite(xf).all(axis=1))
    log(f"[check] {name}: {bad.size} lanes with non-finite states "
        f"{bad[:8].tolist()}; iterations {it.min()}..{it.max()}; "
        f"{failed.sum()} lanes stopped on non-finite gains in some cycle "
        f"({per_cycle.sum()} solves) {np.flatnonzero(failed)[:8].tolist()}")
    require(bad.size == 0, f"{name}: non-finite states")
    require(it.min() >= 1 and it.max() <= max_it, f"{name}: iterations")
    if "uncertainty_max" in rec:
        um = np.asarray(rec["uncertainty_max"])
        log(f"    uncertainty max in [{np.nanmin(um):.4f}, {np.nanmax(um):.4f}], "
            f"{int(np.isnan(um).sum())} NaN")
        require(np.isfinite(um).all() and um.min() >= 0.0 and um.max() <= 100.0,
                f"{name}: uncertainty maps outside [0, 100]")
    return failed


def solve_distance(got, want):
    """Per-lane (head |dU| over the first 10 steps, relative |dJ|)."""
    Ug, Uw = np.asarray(got.U, np.float64), np.asarray(want.U, np.float64)
    Jg, Jw = np.asarray(got.J, np.float64), np.asarray(want.J, np.float64)
    head = np.abs(Ug[:, :10] - Uw[:, :10]).max(axis=(1, 2))
    return head, np.abs(Jg - Jw) / np.maximum(np.abs(Jw), 1e-6)


def loop_distance(xf, want):
    """Per-lane max |dx| [m] of final closed-loop positions."""
    return np.abs(np.asarray(xf, np.float64)[:, :2]
                  - np.asarray(want, np.float64)[:, :2]).max(axis=1)


def fork_gate(apart, share_key="forks", block_key="block_forks"):
    """Lanes apart between two float32 runs: their share, and how many fall
    in one 64-lane program, are bounded."""
    pad = -apart.size % BLOCK
    per_block = np.concatenate([apart, np.zeros(pad, bool)]).reshape(-1, BLOCK).sum(1)
    log(f"    {apart.sum()}/{apart.size} lanes apart "
        f"{np.flatnonzero(apart)[:12].tolist()}; at most {per_block.max()} "
        f"in one {BLOCK}-lane program")
    _limit(share_key, float(apart.mean()))
    _limit(block_key, int(per_block.max()))


def _max(a):
    return float(a.max()) if a.size else 0.0


def route_gate(name, head, dj, share_key="forks", block_key="block_forks"):
    """Per-lane head |dU| (None when only J is recorded) and relative |dJ|
    of two float32 solves of every lane.  Returns the lanes apart."""
    log(f"[compare] {name}, every lane (route_du {TOL['route_du'][0]:g}, "
        f"route_dj {TOL['route_dj'][0]:g}: {TOL['route_du'][1]}):")
    apart = dj > TOL["route_dj"][0]
    if head is not None:
        _quantiles("head |dU|", head)
        apart |= head > TOL["route_du"][0]
    _quantiles("rel |dJ|", dj)
    fork_gate(apart, share_key, block_key)
    return apart


def compare_routes(name, got, want):
    """Every lane of two float32 solves (the GPU route and the XLA route, or
    a sharded and an unsharded run).  Returns the lanes apart."""
    return route_gate(name, *solve_distance(got, want))


def compare_loop_routes(name, xf, rec, want, rec_want):
    """Every lane of two float32 closed loops: the first cycle's J (same
    inputs on both) to ``route_dj``, then the final positions, where forks
    in any cycle have added up, to ``loop_dx``; both with the closed-loop
    fork limits.  Returns the lanes whose final positions lie more than
    ``route_dx`` apart."""
    J, Jw = (np.asarray(r["J"][0], np.float64) for r in (rec, rec_want))
    route_gate(f"{name}, first cycle", None,
               np.abs(J - Jw) / np.maximum(np.abs(Jw), 1e-6),
               "loop_forks", "loop_block_forks")
    dx = loop_distance(xf, want)
    log(f"[compare] {name}, final positions of every lane (loop_dx "
        f"{TOL['loop_dx'][0]:g} m):")
    _quantiles("final |dx| [m]", dx)
    fork_gate(dx > TOL["loop_dx"][0], "loop_forks", "loop_block_forks")
    return dx > TOL["route_dx"][0]


def sample_lanes(B, failed):
    """N_REF lanes spread over the batch and up to N_REF_FAILED of the lanes
    that stopped on non-finite gains."""
    spread = np.linspace(0, B - 1, N_REF).astype(int)
    return np.unique(np.concatenate([spread, np.flatnonzero(failed)[:N_REF_FAILED]]))


def compare_with_f64(name, lanes, d, ok, d32, ok32, forks, failed):
    """Sampled lanes against the float64 XLA route: per-lane distance ``d``
    and agreement ``ok`` of the GPU route, ``d32``/``ok32`` of the float32
    XLA route.  At least ``agree`` of the lanes agree, and a lane the GPU
    route alone puts apart from float64 must be a fork between the two
    float32 routes (``forks``)."""
    log(f"[compare] {name}, {lanes.size} lanes vs float64: GPU route "
        f"{ok.sum()} agree (max distance {_max(d[ok]):.3e}), float32 XLA route "
        f"{ok32.sum()} agree (max distance {_max(d32[ok32]):.3e})")
    log(f"    apart on the GPU route {lanes[~ok].tolist()}, on the float32 XLA "
        f"route {lanes[~ok32].tolist()}; max distance {d.max():.3e}")
    fl = failed[lanes]
    if fl.any():
        log(f"    lanes that stopped on non-finite gains {lanes[fl].tolist()}: "
            f"agree with float64 {ok[fl].tolist()}, distance "
            f"{[float(f'{x:.3e}') for x in d[fl]]}")
    _limit("agree", float(ok.mean()), at_least=True)
    alone = ~ok & ok32 & ~forks
    require(not alone.any(), f"{name}: lanes {lanes[alone].tolist()} apart from "
            "float64 on the GPU route only, and equal on both float32 routes")


def compare_solves(name, lanes, got, want, xla32, forks, failed):
    def dist(r):
        head, dj = solve_distance(r, want)
        return head, (head <= TOL["head_du"][0]) & (dj <= TOL["rel_dj"][0])

    log(f"    a lane agrees with float64 within head_du {TOL['head_du'][0]:g} "
        f"({TOL['head_du'][1]}) and rel_dj {TOL['rel_dj'][0]:g}")
    compare_with_f64(name, lanes, *dist(got), *dist(xla32), forks, failed)


def compare_loops(name, lanes, xf, want, xf32, forks, failed):
    def dist(x):
        dx = loop_distance(x, want)
        return dx, dx <= TOL["loop_dx"][0]

    log(f"    a lane agrees with float64 within loop_dx {TOL['loop_dx'][0]:g} "
        f"({TOL['loop_dx'][1]})")
    compare_with_f64(name, lanes, *dist(xf), *dist(xf32), forks, failed)


def to64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def one_card():
    """Phases 1-3 on one device, at the full widths above."""
    import jax
    import jax.numpy as jnp

    from cilqr_tpu.models import reference_path as rp, solver, solver_batched
    from cilqr_tpu.ops import costmap, gridmap, lm_pallas, uncertainty_pallas
    from cilqr_tpu.parallel import monte_carlo as mc
    from cilqr_tpu.sim import plant
    from cilqr_tpu.sim.example_scenario import example_global_map, example_scenario
    from cilqr_tpu.utils.device import card_info, time_calls
    from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams

    require(lm_pallas.BLOCK == BLOCK, "BLOCK differs from the kernel's")
    f32 = jnp.float32
    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, f32)
    rng = np.random.default_rng(0)
    still = NoiseParams(0.0, 0.0, 0.0)
    take = lambda tree, lanes: jax.tree.map(lambda a: a[lanes], tree)

    def scatter(B, s=0.3):
        return jnp.asarray(np.asarray(ego)[None] + rng.normal(0, s, (B, 4)), f32)

    # --- batched solve --------------------------------------------------
    egos = scatter(B_SOLVE)
    U0s = jnp.broadcast_to(U0, (B_SOLVE,) + U0.shape)
    solve = lambda e, u: solver_batched.run_steps_batched(
        p, plan, n, e, u, obstacles, unc)

    # --- Monte-Carlo ----------------------------------------------------
    sigma_hi = (0.16, 0.16, 0.017)  # Experiment.launch:7-12 magnitudes
    cp = CostmapParams()
    center = (cp.x_position, cp.y_position)
    cp = mc.ensure_window_covers(cp, cp.rows, cp.cols, center, sigma_hi)
    band = costmap.make_band_plan(cp, cp.rows, cp.cols, center, sigma_hi)
    prior = jnp.asarray(rng.uniform(0.0, 100.0, (cp.rows, cp.cols)), f32)
    geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols, dtype=f32)
    oxy, oyaw = jnp.asarray(np.asarray(ego)[:2], f32), jnp.asarray(ego[3], f32)
    samples = mc.sample_scenarios(jax.random.key(1), B_MC, np.asarray(ego),
                                  sigma_hi=sigma_hi, dtype=f32)
    mc_fn = lambda sg, eg: mc.monte_carlo(
        p, cp, prior, geom, oxy, oyaw, plan, n, mc.MCSample(sg, eg), obstacles,
        sigma_hi=sigma_hi, band_plan=band)

    # --- full stack -----------------------------------------------------
    cpf = CostmapParams()
    gmap, ggeom = example_global_map(f32)
    xr, yr = costmap.corridor_center_bounds(cpf, plan, n)
    fs_band = costmap.make_band_plan_bounds(
        cpf, cpf.rows, cpf.cols, xr, yr,
        (cpf.sigma_x, cpf.sigma_y, cpf.sigma_theta))
    x0_fs = scatter(B_FS)

    def fs_fn(x0s, key):
        return plant.closed_loop_full_stack_batched(
            p, cpf, still, gmap, ggeom, plan, n, x0s, key, CYCLES_FS,
            obstacles=obstacles, band_plan=fs_band)

    # --- shared-world closed loop ---------------------------------------
    x0_cl = scatter(B_CL)

    def cl_fn(x0s, key):
        return plant.closed_loop_batched(p, still, plan, n, x0s, key, CYCLES_CL,
                                         obstacles=obstacles, unc_map=unc)

    key = jax.random.key(3)
    log(f"[route] batched solve takes the "
        f"{'GPU kernel' if solver_batched.kernel_route(egos, obstacles) else 'XLA'} route; "
        f"propagation takes the "
        f"{'GPU kernel' if costmap.kernel_route(prior.dtype) else 'XLA'} route")

    # ---------------- phase 1: compile ----------------------------------
    t_phase = time.perf_counter()
    programs = [
        ("batched solve", solve, (egos, U0s), B_SOLVE),
        ("Monte-Carlo", mc_fn, (samples.sigmas, samples.egos), B_MC),
        (f"full stack x{CYCLES_FS}", fs_fn, (x0_fs, key), B_FS),
        (f"closed loop x{CYCLES_CL}", cl_fn, (x0_cl, key), B_CL),
    ]
    gpu, xla = {}, {}
    for name, fn, args, B in programs:
        gpu[name] = compile_program(f"{name} B={B}, GPU route", fn, *args)
        with xla_only():
            xla[name] = compile_program(f"{name} B={B}, XLA route", fn, *args)
    log(f"[phase 1] {time.perf_counter() - t_phase:.1f} s")

    # ---------------- phase 2: run and compare ---------------------------
    t_phase = time.perf_counter()
    for name, ref_fn, args in (
        ("batched solve",
         lambda e, u: solver_batched.run_steps_batched(
             p, *to64((plan, n)), e, u, *to64((obstacles, unc))),
         (egos, U0s)),
        ("Monte-Carlo",
         lambda sg, eg: mc.monte_carlo_reference(
             p, cp, *to64((prior, geom, oxy, oyaw, plan, n)),
             mc.MCSample(sg, eg), to64(obstacles)),
         (samples.sigmas, samples.egos)),
    ):
        res = gpu[name](*args)
        res32 = xla[name](*args)
        failed = (check_solve(f"{name}, GPU route", res, p.max_iterations)
                  | check_solve(f"{name}, XLA route", res32, p.max_iterations))
        forks = compare_routes(f"{name}, GPU vs XLA route in float32", res, res32)
        lanes = sample_lanes(args[0].shape[0], failed)
        with jax.enable_x64(True):
            ref = jax.jit(ref_fn)(*to64(take(args, lanes)))
        compare_solves(name, lanes, take(res, lanes), ref, take(res32, lanes),
                       forks[lanes], failed)

    # the propagation kernel alone, every map, at the Monte-Carlo width and
    # at the full-stack shape (per-scenario priors and frames)
    no_obs = (jnp.zeros((1, 2), f32), jnp.ones((1, 2), f32), jnp.zeros(1, f32),
              jnp.zeros(1, f32))
    vm_fs, _, _, geom_fs = jax.jit(jax.vmap(lambda e: costmap._costmap_pre(
        cpf, gmap, ggeom, plan, n, e, *no_obs)))(x0_fs)
    prop = {
        f"MC B={B_MC}": (cp, band, (prior, geom, oyaw, samples.sigmas)),
        f"full stack B={B_FS}": (cpf, fs_band, (vm_fs, geom_fs, x0_fs[:, 3], None)),
    }
    prop_fns = {}
    for shape, (cpx, bp, pargs) in prop.items():
        kern = fresh(lambda pr, g, y, sg, cpx=cpx, bp=bp:
                     uncertainty_pallas.propagate_batched(cpx, pr, g, y, sg, bp))
        with xla_only():
            ref = compile_program(
                f"propagation, {shape} shape, XLA route",
                lambda pr, g, y, sg, cpx=cpx, bp=bp:
                costmap.propagate_uncertainty_batched(cpx, pr, g, y, sg, bp), *pargs)
        prop_fns[shape] = (kern, ref, pargs)
        u_k, u_r = kern(*pargs), ref(*pargs)
        log(f"[compare] propagation kernel, {shape} shape, every one of "
            f"{u_k.shape[0]} maps {u_k.shape[1]}x{u_k.shape[2]}, "
            f"R<={cpx.window_radius}: range [{float(u_k.min()):.3f}, "
            f"{float(u_k.max()):.3f}]")
        require(bool(jnp.isfinite(u_k).all()) and float(u_k.min()) >= 0.0
                and float(u_k.max()) <= 100.0, f"propagation, {shape}: range")
        _limit("unc", float(jnp.max(jnp.abs(u_k - u_r))))

    for name, ref_fn, (x0s, kk) in (
        (f"full stack x{CYCLES_FS}",
         lambda x0s, kk: plant.closed_loop_full_stack_batched(
             p, cpf, still, *to64((gmap, ggeom, plan, n)), x0s, kk, CYCLES_FS,
             obstacles=to64(obstacles), band_plan=fs_band),
         (x0_fs, key)),
        (f"closed loop x{CYCLES_CL}",
         lambda x0s, kk: plant.closed_loop_batched(
             p, still, *to64((plan, n)), x0s, kk, CYCLES_CL,
             obstacles=to64(obstacles), unc_map=to64(unc)),
         (x0_cl, key)),
    ):
        xf, rec = gpu[name](x0s, kk)
        xf32, rec32 = xla[name](x0s, kk)
        failed = (check_loop(f"{name}, GPU route", xf, rec, p.max_iterations)
                  | check_loop(f"{name}, XLA route", xf32, rec32, p.max_iterations))
        forks = compare_loop_routes(f"{name}, GPU vs XLA route in float32",
                                    xf, rec, xf32, rec32)
        lanes = sample_lanes(x0s.shape[0], failed)
        with jax.enable_x64(True):
            xf_ref, _ = jax.jit(ref_fn)(to64(x0s[lanes]), kk)
        compare_loops(name, lanes, np.asarray(xf)[lanes], xf_ref,
                      np.asarray(xf32)[lanes], forks[lanes], failed)

    r1 = solver.run_step_jit(p, plan, n, ego, U0, obstacles, unc)
    jax.block_until_ready(r1)
    size = solver.run_step_jit._cache_size()
    t0 = time.perf_counter()
    r2 = solver.run_step_jit(p, plan, n, egos[1], r1.U, obstacles, unc)
    jax.block_until_ready(r2)
    t_hit = time.perf_counter() - t0
    require(solver.run_step_jit._cache_size() == size, "second call recompiled")
    check_solve("run_step_jit", jax.tree.map(lambda a: a[None], r2), p.max_iterations)
    log(f"[check] run_step_jit second call hit the jit cache: {t_hit * 1e3:.2f} ms")
    log(f"[phase 2] {time.perf_counter() - t_phase:.1f} s")

    # ---------------- phase 3: kernel timing ----------------------------
    t_phase = time.perf_counter()
    card = card_info()

    def timed(label, fn, args):
        med, lo, hi = time_calls(fn, [args], 5)
        log(f"[time] {label}: {med * 1e3:.3f} ms (min {lo * 1e3:.3f}, "
            f"max {hi * 1e3:.3f}; median of 5) on {card}")

    for Bt in (B_SOLVE, 1):
        e, u = egos[:Bt], U0s[:Bt]
        plans = jax.jit(jax.vmap(lambda x: rp.get_local_plan(p, plan, n, x)))(e)
        timed(f"LM kernel alone, B={Bt}", jax.jit(
            lambda pl_, e_, u_: lm_pallas.fused_optimize(
                p, pl_, e_, u_, obstacles, unc)), (plans, e, u))
        timed(f"LM XLA route alone, B={Bt}", jax.jit(
            lambda pl_, e_, u_: solver_batched.batched_optimize(
                p, pl_, e_, u_, obstacles, unc)), (plans, e, u))
        if Bt == B_SOLVE:
            run_gpu, run_xla = gpu["batched solve"], xla["batched solve"]
        else:
            run_gpu = fresh(solve)
            with xla_only():
                run_xla = fresh(solve)
                jax.block_until_ready(run_xla(e, u))  # trace on the XLA route
        timed(f"batched solve pipeline, GPU route, B={Bt}", run_gpu, (e, u))
        timed(f"batched solve pipeline, XLA route, B={Bt}", run_xla, (e, u))

    for shape, (kern, ref, pargs) in prop_fns.items():
        timed(f"propagation kernel alone, {shape}", kern, pargs)
        timed(f"propagation XLA route alone, {shape}", ref, pargs)
    for name, args in (("Monte-Carlo", (samples.sigmas, samples.egos)),
                       (f"full stack x{CYCLES_FS}", (x0_fs, key))):
        timed(f"{name} pipeline, GPU route", gpu[name], args)
        timed(f"{name} pipeline, XLA route", xla[name], args)
    timed(f"closed loop x{CYCLES_CL} pipeline, GPU route, B={B_CL}",
          gpu[f"closed loop x{CYCLES_CL}"], (x0_cl, key))
    timed(f"prior resample (vmap sample_prior), full stack B={B_FS}", jax.jit(
        lambda g, e: jax.vmap(lambda g1, e1: costmap.sample_prior(
            g1, cpf.rows, cpf.cols, gmap, ggeom, e1[:2], e1[3]))(g, e)),
        (geom_fs, x0_fs))
    log(f"[phase 3 timing] {time.perf_counter() - t_phase:.1f} s")


def gpu_test_tier():
    """The GPU test tier, in this process (one process holds the card)."""
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/test_gpu_chip.py"])
    log("[phase 3] pytest -m gpu:", int(rc))
    require(rc == 0, f"GPU test tier failed: {rc}")


def four_cards(B=4 * 2048, cycles=5):
    """Sharded Monte-Carlo and full stack on a 1-D mesh over four devices,
    each compared lane by lane with the per-shard unsharded runs."""
    import jax
    import jax.numpy as jnp

    from cilqr_tpu.ops import costmap, gridmap
    from cilqr_tpu.parallel import batch as pbatch, monte_carlo as mc
    from cilqr_tpu.sim import plant
    from cilqr_tpu.sim.example_scenario import example_global_map, example_scenario
    from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams

    f32 = jnp.float32
    devices = jax.devices()[:4]
    require(len(devices) == 4, f"four devices needed: {devices}")
    mesh = pbatch.make_mesh(devices)
    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, f32)
    rng = np.random.default_rng(4)
    Bl = B // 4

    sigma_hi = (0.16, 0.16, 0.017)
    cp = CostmapParams()
    center = (cp.x_position, cp.y_position)
    prior = jnp.asarray(rng.uniform(0.0, 100.0, (cp.rows, cp.cols)), f32)
    geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols, dtype=f32)
    oxy, oyaw = jnp.asarray(np.asarray(ego)[:2], f32), jnp.asarray(ego[3], f32)
    samples = mc.sample_scenarios(jax.random.key(5), B, np.asarray(ego),
                                  sigma_hi=sigma_hi, dtype=f32)
    mc_fn, shard = mc.make_sharded_monte_carlo(
        p, cp, mesh, obstacles=obstacles, map_shape=(cp.rows, cp.cols),
        map_center=center, sigma_hi=sigma_hi)
    t0 = time.perf_counter()
    res, metrics = mc_fn(prior, geom, oxy, oyaw, plan, n,
                         jax.device_put(samples.sigmas, shard),
                         jax.device_put(samples.egos, shard))
    jax.block_until_ready(res)
    log(f"[four cards] sharded Monte-Carlo B={B}: {time.perf_counter() - t0:.1f} s "
        f"(with compile); devices {sorted(d.id for d in res.U.sharding.device_set)}")
    require(len(res.U.sharding.device_set) == 4, "Monte-Carlo not on four devices")

    cp_w = mc.ensure_window_covers(cp, cp.rows, cp.cols, center, sigma_hi)
    band = costmap.make_band_plan(cp_w, cp.rows, cp.cols, center, sigma_hi)
    one = jax.jit(lambda sg, eg: mc.monte_carlo(
        p, cp_w, prior, geom, oxy, oyaw, plan, n, mc.MCSample(sg, eg),
        obstacles, sigma_hi=sigma_hi, band_plan=band))
    want = [one(samples.sigmas[d * Bl:(d + 1) * Bl], samples.egos[d * Bl:(d + 1) * Bl])
            for d in range(4)]
    want = jax.tree.map(lambda *a: np.concatenate([np.asarray(x) for x in a]), *want)
    # XLA fuses the sharded and the unsharded programs differently, so their
    # float32 sums differ in the last bits: the limits of two float32 routes
    compare_routes("sharded Monte-Carlo vs per-shard unsharded", res, want)
    log(f"    mean J {float(metrics.mean_J):.6f} vs {want.J.mean():.6f}")
    require(abs(float(metrics.mean_J) - want.J.mean()) <= 1e-3 * abs(want.J.mean()),
            "mean J")

    cpf = CostmapParams()
    gmap, ggeom = example_global_map(f32)
    fs_fn, fs_shard = pbatch.make_sharded_full_stack(
        p, cpf, mesh, n_cycles=cycles, obstacles=obstacles)
    x0s = jnp.asarray(np.asarray(ego)[None] + rng.normal(0, 0.3, (B, 4)), f32)
    key = jax.random.key(6)
    t0 = time.perf_counter()
    xf, rec, summary = fs_fn(gmap, ggeom, plan, n, jax.device_put(x0s, fs_shard), key)
    jax.block_until_ready(xf)
    log(f"[four cards] sharded full stack B={B} x{cycles}: "
        f"{time.perf_counter() - t0:.1f} s (with compile); devices "
        f"{sorted(d.id for d in xf.sharding.device_set)}")
    require(len(xf.sharding.device_set) == 4, "full stack not on four devices")
    chunk = jax.jit(lambda x, kk: plant.closed_loop_full_stack_batched(
        p, cpf, NoiseParams(), gmap, ggeom, plan, n, x, kk, cycles,
        obstacles=obstacles))
    parts = [chunk(x0s[d * Bl:(d + 1) * Bl], jax.random.fold_in(key, d))
             for d in range(4)]
    xf_want = np.concatenate([np.asarray(x) for x, _ in parts])
    # record leaves are (cycles, B, ...): the scenario axis is axis 1
    J_want = np.concatenate([np.asarray(r["J"]) for _, r in parts], axis=1)
    log(f"[four cards] collision share {float(summary[1]):.4f}")
    compare_loop_routes("sharded full stack vs per-shard unsharded", xf, rec,
                        xf_want, {"J": J_want})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded campaign on four cards")
    args = ap.parse_args()
    t0 = time.perf_counter()
    dev = device_check()

    from cilqr_tpu.utils.compile_cache import enable_compilation_cache
    from cilqr_tpu.utils.device import card_info

    log(card_info())
    enable_compilation_cache()
    if args.four_cards:
        four_cards()
    else:
        one_card()
        gpu_test_tier()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main()
