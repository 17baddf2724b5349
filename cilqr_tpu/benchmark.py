"""Benchmark: batched uncertainty-aware CILQR on one GPU.

Headline (BASELINE.json): CILQR solves/s at N=50 horizon with full barrier
constraints (control bounds, elliptic obstacles, uncertainty-map barrier),
one (B, ...) batch per call through ``solver_batched.run_steps_batched``.

Prints the card's name and power limit (``nvidia-smi``), then ONE JSON line
with the device as JAX reports it.  Exits non-zero without a GPU.  Every
time is the median of BENCH_PASSES (default 5) calls, each ended by
``block_until_ready``, with [min, max] as its spread.

Env: BENCH_BATCH (default 32768), BENCH_PASSES (default 5), BENCH_MC /
BENCH_FULL_STACK / BENCH_CLOSED_LOOP (default 1 — the Monte-Carlo,
full-pipeline and closed-loop throughputs; 0 skips one).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np


def main():
    from cilqr_tpu.utils.device import card_info, require_gpu, time_calls

    card = card_info()
    print(card, flush=True)
    device = require_gpu()

    import jax
    import jax.numpy as jnp

    from cilqr_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from cilqr_tpu.models import solver, solver_batched
    from cilqr_tpu.sim.example_scenario import example_scenario
    from cilqr_tpu.utils.params import SolverParams

    B = int(os.environ.get("BENCH_BATCH", "32768"))
    passes = int(os.environ.get("BENCH_PASSES", "5"))
    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, jnp.float32)

    rng = np.random.default_rng(2)
    egos = [
        jnp.asarray(np.asarray(ego)[None, :] + rng.normal(0, 0.3, (B, 4)),
                    jnp.float32)
        for _ in range(2)
    ]
    U0s = jnp.broadcast_to(U0, (B,) + U0.shape)

    fn = jax.jit(lambda e, u: solver_batched.run_steps_batched(
        p, plan, n, e, u, obstacles, unc))
    dt, lo, hi = time_calls(fn, [(e, U0s) for e in egos], passes)
    mean_iters = float(jnp.mean(fn(egos[0], U0s).iterations.astype(jnp.float32)))

    single = jax.jit(lambda e, u: solver.run_step(p, plan, n, e, u, obstacles, unc))
    one = [(egos[0][i], U0) for i in range(8)]
    t1, t1_lo, t1_hi = time_calls(single, one, max(passes, 20))
    t1b, _, _ = time_calls(
        jax.jit(lambda e, u: solver_batched.run_steps_batched(
            p, plan, n, e[None], u[None], obstacles, unc)),
        one, max(passes, 20))

    out = {
        "metric": "cilqr_solves_per_sec_N50_full_constraints",
        "value": B / dt,
        "value_spread": [B / hi, B / lo],
        "unit": "solves/s",
        "batch": B,
        "batched_step_ms": dt * 1e3,
        "mean_lm_iterations": mean_iters,
        "single_solve_ms": t1 * 1e3,
        "single_solve_ms_spread": [t1_lo * 1e3, t1_hi * 1e3],
        "batched_b1_solve_ms": t1b * 1e3,
        "kernel_route": solver_batched.kernel_route(egos[0], obstacles),
    }

    if os.environ.get("BENCH_MC", "1") == "1":
        from cilqr_tpu.ops import costmap as costmap_mod, gridmap
        from cilqr_tpu.parallel import monte_carlo as mc_mod
        from cilqr_tpu.utils.params import CostmapParams

        # reference experiment magnitudes (Experiment.launch:7-12)
        sigma_hi = (0.16, 0.16, 0.017)
        cp = CostmapParams()
        center = (cp.x_position, cp.y_position)
        cp = mc_mod.ensure_window_covers(cp, cp.rows, cp.cols, center, sigma_hi)
        band_plan = costmap_mod.make_band_plan(cp, cp.rows, cp.cols, center, sigma_hi)
        prior = jnp.asarray(rng.uniform(0.0, 100.0, (cp.rows, cp.cols)), jnp.float32)
        geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols,
                                 dtype=jnp.float32)
        Bmc = int(os.environ.get("BENCH_MC_BATCH", "8192"))
        base = np.asarray(ego)
        samples = [
            mc_mod.sample_scenarios(jax.random.key(k), Bmc, base,
                                    sigma_hi=sigma_hi, dtype=jnp.float32)
            for k in range(2)
        ]
        mc_fn = jax.jit(lambda sg, eg: mc_mod.monte_carlo(
            p, cp, prior, geom, jnp.asarray(base[:2], jnp.float32),
            jnp.asarray(base[3], jnp.float32), plan, n,
            mc_mod.MCSample(sg, eg), obstacles, sigma_hi=sigma_hi,
            band_plan=band_plan))
        t, t_lo, t_hi = time_calls(mc_fn, [tuple(s) for s in samples], passes)
        out["mc_scenarios_per_sec"] = Bmc / t
        out["mc_scenarios_per_sec_spread"] = [Bmc / t_hi, Bmc / t_lo]

    if os.environ.get("BENCH_FULL_STACK", "1") == "1":
        from cilqr_tpu.ops import costmap as costmap_mod
        from cilqr_tpu.sim import plant
        from cilqr_tpu.sim.example_scenario import example_global_map
        from cilqr_tpu.utils.params import CostmapParams, NoiseParams

        cpf = CostmapParams()
        Bfs = int(os.environ.get("BENCH_FS_BATCH", "8192"))
        n_cyc = 5
        # the inputs chip_smoke.py checks: random prior, no localization noise
        gmap, ggeom = example_global_map(jnp.float32)
        x0s = [
            jnp.asarray(np.asarray(ego)[None, :] + rng.normal(0, 0.3, (Bfs, 4)),
                        jnp.float32)
            for _ in range(2)
        ]
        xr, yr = costmap_mod.corridor_center_bounds(cpf, plan, n)
        fs_band = costmap_mod.make_band_plan_bounds(
            cpf, cpf.rows, cpf.cols, xr, yr,
            (cpf.sigma_x, cpf.sigma_y, cpf.sigma_theta))
        fs = jax.jit(lambda x, k: plant.closed_loop_full_stack_batched(
            p, cpf, NoiseParams(0.0, 0.0, 0.0), gmap, ggeom, plan, n, x, k, n_cyc,
            obstacles=obstacles, band_plan=fs_band))
        t, t_lo, t_hi = time_calls(
            fs, [(x, jax.random.key(i)) for i, x in enumerate(x0s)], passes)
        out["full_stack_cycles_per_sec"] = n_cyc * Bfs / t
        out["full_stack_cycles_per_sec_spread"] = [n_cyc * Bfs / t_hi,
                                                   n_cyc * Bfs / t_lo]

    if os.environ.get("BENCH_CLOSED_LOOP", "1") == "1":
        from cilqr_tpu.sim import plant
        from cilqr_tpu.utils.params import NoiseParams

        n_cycles = 10
        cl = jax.jit(lambda x0s, k: plant.closed_loop_batched(
            p, NoiseParams(0.0, 0.0, 0.0), plan, n, x0s, k, n_cycles,
            obstacles=obstacles, unc_map=unc))
        t, t_lo, t_hi = time_calls(
            cl, [(e, jax.random.key(i)) for i, e in enumerate(egos)], passes)
        out["closed_loop_cycles_per_sec"] = n_cycles * B / t
        out["closed_loop_cycles_per_sec_spread"] = [n_cycles * B / t_hi,
                                                    n_cycles * B / t_lo]

    out["device"] = device
    out["card"] = card
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
