"""Real 2-process ``jax.distributed`` bring-up (CPU, gloo collectives).

Covers the one code path single-process virtual meshes never execute
(``parallel/multihost.py``: ``initialize``/``scatter_local``/``put_global``
and the cross-process psum), asserting the distributed results are
IDENTICAL to the in-process single-controller ground truth:

  * sharded solve over a 2-process x 2-device mesh == plain vmap solve,
  * a 2-shard checkpointed campaign + ``merge_analysis`` == the
    single-process campaign, with per-process explog shards that merge
    without double counting.

Reference analog: the 5-process ROS pub/sub graph (SURVEY.md §2.5 P1).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tests import _multihost_worker as worker

pytestmark = pytest.mark.slow  # heavy tier: run with the full suite

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    """Launch the 2-process distributed run once; both tests consume it."""
    out = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = dict(os.environ)
    # the workers own their platform/topology; strip anything inherited
    # from the pytest process (conftest forces an 8-device CPU host)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_multihost_worker.py"),
             str(pid), "2", str(port), str(out)],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for pr in procs:
        try:
            stdout, _ = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for pid, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{log}"
        assert f"worker {pid} OK" in log
    return out


@pytest.fixture(scope="module")
def worker_outputs_two_hosts(tmp_path_factory):
    """2 processes x 4 virtual devices each — a two-host topology (BASELINE
    config 5) — running the checkpointed campaign phase only (exercise the
    multi-host SHAPE itself, not just 2 x 2)."""
    out = tmp_path_factory.mktemp("mh_two_hosts")
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_multihost_worker.py"),
             str(pid), "2", str(port), str(out), "4", "campaign"],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for pr in procs:
        try:
            stdout, _ = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for pid, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"worker {pid} failed:\n{log}"
        assert f"worker {pid} OK" in log
    return out


def test_two_host_shaped_campaign_matches_single_process(worker_outputs_two_hosts,
                                                     tmp_path):
    """The 2-host x 4-device campaign equals the
    single-process 8-device ground truth and its explog shards merge
    without double counting."""
    out = worker_outputs_two_hosts
    c0 = json.loads((out / "campaign_0.json").read_text())
    c1 = json.loads((out / "campaign_1.json").read_text())
    assert c0 == c1  # psum-global state is replicated across hosts
    assert c0["rounds"] == 2 and c0["solves"] == 32

    import jax

    from cilqr_tpu.ops import gridmap
    from cilqr_tpu.parallel import batch as pbatch, campaign

    p, cp = worker.make_params()
    plan, n, _, _ = worker.make_inputs(p, jnp.float32)
    prior = jnp.asarray(
        np.random.default_rng(2).uniform(0, 100, (cp.rows, cp.cols)),
        jnp.float32)
    geom = gridmap.make_geom(
        [5.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float32)
    ego = np.array([100.0, -305.8, 4.0, 0.02], np.float32)
    ref = campaign.run_campaign(
        p, cp, pbatch.make_mesh(jax.devices("cpu")), prior, geom,
        ego[:2], ego[3], plan.astype(jnp.float32), n, ego,
        n_rounds=2, batch=16, out_dir=str(tmp_path / "ref"), seed=7,
        resume=False,
    )
    assert c0["solves"] == ref["solves"]
    np.testing.assert_allclose(c0["mean_J"], ref["mean_J"], rtol=1e-5)
    np.testing.assert_allclose(c0["max_J"], ref["max_J"], rtol=1e-5)
    np.testing.assert_allclose(
        c0["mean_iterations"], ref["mean_iterations"], rtol=1e-6)

    shards = sorted((out / "campaign").glob("shard_*.log"))
    assert [s.name for s in shards] == ["shard_000.log", "shard_001.log"]
    merged = campaign.merge_analysis(str(out / "campaign"))
    assert merged["rounds"] == 4 and merged["solves"] == 32
    np.testing.assert_allclose(merged["mean_J"], ref["mean_J"], rtol=1e-5)


def test_two_process_solve_matches_single_process(worker_outputs):
    out = worker_outputs
    p, _ = worker.make_params()
    plan, n, egos, U0 = worker.make_inputs(p, jnp.float64)

    # single-controller ground truth (plain vmap, no mesh)
    from cilqr_tpu.parallel import batch as pbatch

    res, metrics = pbatch.solve_and_reduce(
        p, plan, n, jnp.asarray(egos), jnp.asarray(U0))

    # reassemble the global result from each process's addressable shards
    B = egos.shape[0]
    J = np.full((B,), np.nan)
    U = np.full((B, p.horizon, 2), np.nan)
    for pid in range(2):
        z = np.load(out / f"solve_{pid}.npz")
        lo = int(z["lo"])
        J[lo:lo + z["J"].shape[0]] = z["J"]
        U[lo:lo + z["U"].shape[0]] = z["U"]
    assert np.isfinite(J).all()
    np.testing.assert_allclose(J, np.asarray(res.J), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(U, np.asarray(res.U), rtol=1e-10, atol=1e-12)

    # the replicated psum metrics match on every process and equal the
    # single-process reduction (gather_metrics exercised on real BatchMetrics)
    md0 = json.loads((out / "solve_0.json").read_text())
    md1 = json.loads((out / "solve_1.json").read_text())
    assert md0 == md1
    for k, v in md0.items():
        np.testing.assert_allclose(
            v, float(np.asarray(getattr(metrics, k))), rtol=1e-9, err_msg=k)


def test_two_process_campaign_matches_single_process(worker_outputs, tmp_path):
    out = worker_outputs
    c0 = json.loads((out / "campaign_0.json").read_text())
    c1 = json.loads((out / "campaign_1.json").read_text())
    assert c0 == c1  # psum-global state is replicated
    assert c0["rounds"] == 2 and c0["solves"] == 32

    # single-process ground truth on the in-process (8-device) mesh
    import jax

    from cilqr_tpu.models import reference_path as rp  # noqa: F401
    from cilqr_tpu.ops import gridmap
    from cilqr_tpu.parallel import batch as pbatch, campaign

    p, cp = worker.make_params()
    plan, n, _, _ = worker.make_inputs(p, jnp.float32)
    prior = jnp.asarray(
        np.random.default_rng(2).uniform(0, 100, (cp.rows, cp.cols)),
        jnp.float32)
    geom = gridmap.make_geom(
        [5.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float32)
    ego = np.array([100.0, -305.8, 4.0, 0.02], np.float32)
    ref = campaign.run_campaign(
        p, cp, pbatch.make_mesh(jax.devices("cpu")), prior, geom,
        ego[:2], ego[3], plan.astype(jnp.float32), n, ego,
        n_rounds=2, batch=16, out_dir=str(tmp_path / "ref"), seed=7,
        resume=False,
    )
    assert c0["solves"] == ref["solves"]
    np.testing.assert_allclose(c0["mean_J"], ref["mean_J"], rtol=1e-5)
    np.testing.assert_allclose(c0["max_J"], ref["max_J"], rtol=1e-5)
    np.testing.assert_allclose(
        c0["mean_iterations"], ref["mean_iterations"], rtol=1e-6)

    # two explog shards exist (one per process) and merge without double
    # counting: 2 shards x 2 rounds, 32 unique solves total
    shards = sorted((out / "campaign").glob("shard_*.log"))
    assert [s.name for s in shards] == ["shard_000.log", "shard_001.log"]
    merged = campaign.merge_analysis(str(out / "campaign"))
    assert merged["rounds"] == 4  # rows: 2 shards x 2 rounds
    assert merged["solves"] == 32
    np.testing.assert_allclose(merged["mean_J"], ref["mean_J"], rtol=1e-5)


def test_two_process_full_stack_matches_single_process(worker_outputs):
    """The sharded COMPLETE pipeline (per-cycle per-scenario costmaps +
    perception channel, make_sharded_full_stack) across the 2-process mesh
    equals the single-controller per-shard ground truth: shard i of the
    batch runs closed_loop_full_stack_batched with fold_in(key, i) — the
    exact key discipline shard_fn applies via axis_index."""
    out = worker_outputs
    import jax

    from cilqr_tpu.sim import perception, plant, scenarios
    from cilqr_tpu.sim.runner import build_scenario_inputs
    from cilqr_tpu.ops import gridmap as gm_mod
    from cilqr_tpu.utils.params import NoiseParams

    p, cp = worker.make_params()
    plan, n, _, _ = worker.make_inputs(p, jnp.float32)
    plan32 = plan.astype(jnp.float32)
    sc = scenarios.get_scenario("success1")
    ob, obs_xyyaw, obs_size, obs_mask = build_scenario_inputs(
        p, sc, jnp.float32)
    gmap = jnp.zeros((32, 32), jnp.float32)
    ggeom = gm_mod.make_geom([100.0, -300.0], 2.0, 32, 32, dtype=jnp.float32)
    percept = perception.PerceptionSim(
        0, jnp.asarray([0.5, 0.0], jnp.float32), bbox_sigma=0.0)
    B = 8
    x0s = (np.asarray(sc.start)[None, :]
           + np.random.default_rng(13).normal(0, 0.2, (B, 4))
           ).astype(np.float32)

    # ground truth: 4 device shards of 2 scenarios, each with its own
    # fold_in(key, shard) — no mesh involved
    key = jax.random.key(5)
    xf_ref, J_last = [], []
    n_shards, bs = 4, B // 4
    for i in range(n_shards):
        xf_i, rec_i = plant.closed_loop_full_stack_batched(
            p, cp, NoiseParams(), gmap, ggeom, plan32, n,
            jnp.asarray(x0s[i * bs:(i + 1) * bs]),
            jax.random.fold_in(key, i), 2,
            obstacles=ob, obs_xyyaw=obs_xyyaw, obs_size=obs_size,
            obs_mask=obs_mask, percept=percept,
        )
        xf_ref.append(np.asarray(xf_i))
        J_last.append(np.asarray(rec_i["J"][-1]))
    xf_ref = np.concatenate(xf_ref)
    mean_J_ref = float(np.concatenate(J_last).sum() / B)

    xf = np.full((B, 4), np.nan, np.float32)
    sums = []
    for pid in range(2):
        z = np.load(out / f"fullstack_{pid}.npz")
        n_local = z["xf"].shape[0]
        lo = int(z["starts"][0])
        xf[lo:lo + n_local] = z["xf"]
        sums.append((float(z["mean_J"]), float(z["collision_frac"])))
    assert np.isfinite(xf).all()
    np.testing.assert_allclose(xf, xf_ref, rtol=1e-6, atol=1e-6)
    # the psum summary is replicated across processes and matches
    assert sums[0] == sums[1]
    np.testing.assert_allclose(sums[0][0], mean_J_ref, rtol=1e-5)
