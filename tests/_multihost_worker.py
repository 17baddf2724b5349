"""Subprocess worker for tests/test_multihost.py — REAL multi-process
``jax.distributed`` bring-up on CPU.

This is the code path the virtual 8-device mesh never touches
(``parallel/multihost.py``: ``initialize`` -> ``global_mesh`` ->
``scatter_local``/``put_global``), the multi-process analog of the reference's
5-process ROS graph (SURVEY.md §2.5 P1).  Each worker:

  1. brings up ``jax.distributed`` (2 processes x 2 virtual CPU devices
     = a 4-device global mesh, gloo collectives),
  2. contributes its local half of a global scenario batch via
     ``scatter_local``, runs the sharded solve + psum metric reduction,
     dumps its addressable result shards + the replicated metrics,
  3. runs a 2-round checkpointed Monte-Carlo campaign (both processes in
     lockstep, per-process explog shards).

argv: process_id num_processes port out_dir [devices_per_proc] [mode]

devices_per_proc (default 2): virtual CPU devices per process — 4 gives
a two-host topology of four devices each (2 x 4 = 8 global devices).
mode: "all" (default) or "campaign" (only the checkpointed campaign — the
two-host-shaped test needs just that phase).

All scenario inputs are deterministic so the parent test can reproduce the
single-process ground truth in-process and assert equality.
"""

import json
import pathlib
import sys


def make_params():
    """Small deterministic solver/costmap config (lazy imports: the worker
    must set env vars before the first jax import)."""
    import dataclasses

    from cilqr_tpu.utils.params import CostmapParams, SolverParams

    p = dataclasses.replace(
        SolverParams(), horizon=8, max_iterations=3,
        max_global_plan_points=128, num_of_local_wpts=8,
    )
    cp = dataclasses.replace(CostmapParams(), rows=16, cols=16, window_radius=4)
    return p, cp


def make_inputs(p, dtype):
    """Deterministic plan + B=8 ego batch + warm-start controls (numpy)."""
    import numpy as np

    from cilqr_tpu.models import reference_path as rp, solver

    s = np.linspace(0.0, 60.0, 61)
    plan_np = np.stack([90.0 + s, -306.0 + 0.02 * s], axis=1)
    plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype)
    base = np.array([100.0, -305.8, 4.0, 0.02])
    rng = np.random.default_rng(11)
    egos = (base[None, :] + rng.normal(0, 0.3, (8, 4))).astype(np.float64)
    U0 = np.broadcast_to(
        np.asarray(solver.initial_controls(p, dtype=dtype)), (8, p.horizon, 2)
    ).copy()
    return plan, n, egos, U0


def run_campaign_phase(out, pid, mesh, p, cp, plan, n):
    """2-round checkpointed Monte-Carlo campaign on the given mesh (both
    processes in lockstep, per-process explog shards)."""
    import json as _json

    import jax.numpy as jnp
    import numpy as np

    from cilqr_tpu.ops import gridmap
    from cilqr_tpu.parallel import campaign

    prior = jnp.asarray(
        np.random.default_rng(2).uniform(0, 100, (cp.rows, cp.cols)),
        jnp.float32,
    )
    geom = gridmap.make_geom(
        [5.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float32)
    plan32, n32 = plan.astype(jnp.float32), n
    ego = np.array([100.0, -305.8, 4.0, 0.02], np.float32)
    summary = campaign.run_campaign(
        p, cp, mesh, prior, geom, ego[:2], ego[3], plan32, n32, ego,
        n_rounds=2, batch=16, out_dir=str(out / "campaign"), seed=7,
        resume=False,
    )
    (out / f"campaign_{pid}.json").write_text(_json.dumps(summary))


def main():
    pid, nproc, port, out_dir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    ndev = int(sys.argv[5]) if len(sys.argv) > 5 else 2
    mode = sys.argv[6] if len(sys.argv) > 6 else "all"
    import os

    # before the FIRST jax import: CPU platform, ndev virtual devices/process
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={ndev}"
    ).strip()

    import jax
    import jax.numpy as jnp
    import numpy as np

    # the workers validate the distributed code path on the CPU
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from cilqr_tpu.parallel import batch as pbatch, campaign, multihost

    multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc, process_id=pid,
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == ndev
    mesh = multihost.global_mesh()
    assert mesh.devices.size == ndev * nproc

    out = pathlib.Path(out_dir)
    p, cp = make_params()
    plan, n, egos, U0 = make_inputs(p, jnp.float64)

    if mode == "campaign":
        run_campaign_phase(out, pid, mesh, p, cp, plan, n)
        print(f"worker {pid} OK", flush=True)
        return

    # ---- sharded solve: each process contributes its local half ----
    B = egos.shape[0]
    b = B // nproc
    lo = pid * b
    egos_sh = multihost.scatter_local(mesh, egos[lo:lo + b])
    U_sh = multihost.scatter_local(mesh, U0[lo:lo + b])
    assert egos_sh.shape == (B, 4)  # global view, local storage

    fn, _ = pbatch.make_sharded_solver(p, mesh)
    res, metrics = fn(plan, n, egos_sh, U_sh)
    md = multihost.gather_metrics(metrics)

    shards = sorted(res.J.addressable_shards, key=lambda s: s.index[0].start)
    J_local = np.concatenate([np.asarray(s.data) for s in shards])
    U_shards = sorted(res.U.addressable_shards, key=lambda s: s.index[0].start)
    U_local = np.concatenate([np.asarray(s.data) for s in U_shards])
    np.savez(out / f"solve_{pid}.npz", J=J_local, U=U_local, lo=lo)
    (out / f"solve_{pid}.json").write_text(json.dumps(md))

    # ---- 2-round checkpointed campaign across both processes ----
    run_campaign_phase(out, pid, mesh, p, cp, plan, n)

    # ---- sharded FULL-STACK loop: per-cycle per-scenario costmap rebuild
    # + perception channel under the 2-process mesh (the newest pipeline —
    # each shard folds its mesh position into the key, so the parent test
    # reproduces ground truth per quarter with fold_in(key, i)) ----
    from cilqr_tpu.ops import gridmap as gm_mod
    from cilqr_tpu.sim import perception, scenarios
    from cilqr_tpu.sim.runner import build_scenario_inputs

    sc = scenarios.get_scenario("success1")
    ob, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(
        p, sc, jnp.float32)
    gmap = jnp.zeros((32, 32), jnp.float32)
    ggeom = gm_mod.make_geom([100.0, -300.0], 2.0, 32, 32, dtype=jnp.float32)
    percept = perception.PerceptionSim(
        0, jnp.asarray([0.5, 0.0], jnp.float32), bbox_sigma=0.0)
    fs_fn, _ = pbatch.make_sharded_full_stack(
        p, cp, mesh, n_cycles=2, obstacles=ob,
        obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
        percept=percept,
    )
    x0s = (np.asarray(sc.start)[None, :]
           + np.random.default_rng(13).normal(0, 0.2, (B, 4))
           ).astype(np.float32)
    x0_sh = multihost.scatter_local(mesh, x0s[lo:lo + b])
    # f32 plan for the full-stack pipeline (the solve phase above runs f64;
    # plan32 used to be a module-level alias until run_campaign_phase was
    # extracted — keep the cast local here)
    plan32, n32 = plan.astype(jnp.float32), n
    xf, rec, fsum = fs_fn(gmap, ggeom, plan32, n32, x0_sh, jax.random.key(5))
    xf_shards = sorted(xf.addressable_shards, key=lambda s: s.index[0].start)
    np.savez(
        out / f"fullstack_{pid}.npz",
        xf=np.concatenate([np.asarray(s.data) for s in xf_shards]),
        starts=np.asarray([s.index[0].start for s in xf_shards]),
        mean_J=float(fsum[0]), collision_frac=float(fsum[1]),
    )
    print(f"worker {pid} OK", flush=True)


if __name__ == "__main__":
    main()
