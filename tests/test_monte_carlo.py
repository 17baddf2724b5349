"""Monte-Carlo configs: sampled covariances (config 3) and the sharded
costmap+solve pipeline (config 5) on the virtual mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cilqr_tpu.models import reference_path as rp
from cilqr_tpu.ops import gridmap
from cilqr_tpu.parallel import batch as pbatch, monte_carlo as mc, multihost
from cilqr_tpu.utils.params import CostmapParams, SolverParams
import pytest


def _setup(params):
    p = dataclasses.replace(params, horizon=12, max_iterations=5)
    cp = dataclasses.replace(
        CostmapParams(), rows=24, cols=24, window_radius=8,
    )
    rng = np.random.default_rng(41)
    prior = jnp.asarray(rng.uniform(0, 100, (cp.rows, cp.cols)), jnp.float64)
    geom = gridmap.make_geom([10.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float64)
    s = np.linspace(0, 119, 120)
    plan_np = np.stack([90.0 + s, -306.0 + 2.0 * np.sin(0.05 * s)], axis=1)
    plan, n = rp.pad_global_plan(p, plan_np, dtype=jnp.float64)
    ego = np.array([100.0, -305.8, 4.0, 0.05])
    return p, cp, prior, geom, plan, n, ego


@pytest.mark.slow
def test_sampled_covariances_vary_results(params):
    p, cp, prior, geom, plan, n, ego = _setup(params)
    key = jax.random.key(7)
    samples = mc.sample_scenarios(key, 8, ego, dtype=jnp.float64)
    assert samples.sigmas.shape == (8, 3)
    assert (np.asarray(samples.sigmas) >= 0.005).all()

    res = mc.monte_carlo(
        p, cp, prior, geom,
        jnp.asarray(ego[:2]), jnp.asarray(ego[3]),
        plan, n, samples,
    )
    assert res.U.shape == (8, p.horizon, 2)
    assert np.isfinite(np.asarray(res.U)).all()
    # different sigma draws + ego noise must produce different solutions
    U = np.asarray(res.U)
    assert np.std(U[:, 0, 0]) > 1e-6


@pytest.mark.slow
def test_sharded_monte_carlo_matches_vmap(params):
    p, cp, prior, geom, plan, n, ego = _setup(params)
    mesh = pbatch.make_mesh()
    key = jax.random.key(8)
    B = 16
    samples = mc.sample_scenarios(key, B, ego, dtype=jnp.float64)

    fn, sharding = mc.make_sharded_monte_carlo(p, cp, mesh, map_shape=(cp.rows, cp.cols), map_center=(10.0, 0.0))
    sig = jax.device_put(samples.sigmas, sharding)
    egos = jax.device_put(samples.egos, sharding)
    res, metrics = fn(prior, geom, jnp.asarray(ego[:2]), jnp.asarray(ego[3]),
                      plan, n, sig, egos)
    assert len(res.U.sharding.device_set) == 8

    want = mc.monte_carlo(p, cp, prior, geom, jnp.asarray(ego[:2]),
                          jnp.asarray(ego[3]), plan, n, samples)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(want.U), atol=1e-9)
    np.testing.assert_allclose(float(metrics.mean_J), float(jnp.mean(want.J)), rtol=1e-9)


def test_multihost_helpers_single_process(params):
    multihost.initialize()  # no-op single process
    mesh = multihost.global_mesh()
    assert mesh.devices.size == 8
    local = np.arange(32, dtype=np.float32).reshape(16, 2)
    arr = multihost.scatter_local(mesh, local)
    assert arr.shape == (16, 2)
    np.testing.assert_array_equal(np.asarray(arr), local)

    from cilqr_tpu.parallel.batch import BatchMetrics
    m = BatchMetrics(jnp.asarray(1.0), jnp.asarray(2.0), jnp.asarray(3.0), jnp.asarray(0.5))
    d = multihost.gather_metrics(m)
    assert d == {"mean_J": 1.0, "max_J": 2.0, "mean_iterations": 3.0, "converged_frac": 0.5}


def test_batched_pipeline_matches_reference_at_256(params):
    """B = 256 sampled scenarios: the batched pipeline (batched propagation
    + batched solve with per-scenario maps) equals the per-sample oracle
    (vmap of mc_solve_one) in float64."""
    p, cp, prior, geom, plan, n, ego = _setup(params)
    p = dataclasses.replace(p, horizon=6, max_iterations=3,
                            num_of_local_wpts=8, closest_point_samples_per_wpt=5)
    plan, n = rp.pad_global_plan(
        p, np.asarray(plan[: int(n)]), dtype=jnp.float64)
    samples = mc.sample_scenarios(jax.random.key(11), 256, ego, dtype=jnp.float64)
    args = (p, cp, prior, geom, jnp.asarray(ego[:2]), jnp.asarray(ego[3]),
            plan, n, samples)
    got = mc.monte_carlo(*args)
    want = mc.monte_carlo_reference(*args)
    np.testing.assert_array_equal(
        np.asarray(got.iterations), np.asarray(want.iterations))
    for name in ("X", "U", "J"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=1e-9, atol=1e-9, err_msg=name)
    assert np.std(np.asarray(got.U)[:, 0, 0]) > 1e-6
