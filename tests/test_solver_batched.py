"""The batched solver's XLA route vs the per-scenario reference (vmapped
``solver.run_step``), and the route choice on the CPU backend."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilqr_tpu.models import (
    obstacles as obs_mod,
    reference_path as rp,
    solver,
    solver_batched,
    uncertainty as unc_mod,
)
from cilqr_tpu.ops import gridmap


def _worlds(p, B, rng, dtype):
    """(obstacles, unc_map, per-lane reference worlds) for each world kind."""
    ob = obs_mod.make_static_obstacles(
        p, [[108.0, -305.5]], [[3.63, 1.84]], [0.1], dtype=dtype)
    vals = jnp.asarray(rng.uniform(0, 100, (B, 12, 10)), dtype)
    geom = gridmap.make_geom([104.0, -305.0], 0.5, 12, 10, dtype=dtype)
    o_xy = jnp.asarray([100.0, -305.6], dtype)
    o_yaw = jnp.asarray(0.05, dtype)
    shared = unc_mod.UncertaintyMap(vals[0], geom, o_xy, o_yaw)
    bc = lambda a: jnp.broadcast_to(a, (B,) + jnp.shape(a))
    per_map = unc_mod.UncertaintyMap(vals, jax.tree.map(bc, geom), bc(o_xy), bc(o_yaw))
    ob_b = jax.tree.map(bc, ob)
    return {
        "shared": (ob, shared),
        "per_scenario_maps": (ob, per_map),
        "per_scenario_obstacles": (ob_b, per_map),
    }


@pytest.mark.parametrize(
    "world", ["shared", "per_scenario_maps", "per_scenario_obstacles"])
def test_xla_route_matches_vmapped_run_step(params, global_plan, world):
    """B = 6 (not a power of two): every lane of the batch-level LM loop
    equals its own ``run_step`` in float64 for each kind of world."""
    p = dataclasses.replace(params, horizon=6, max_iterations=3,
                            num_of_local_wpts=8, closest_point_samples_per_wpt=5)
    plan, n = rp.pad_global_plan(p, global_plan, dtype=jnp.float64)
    B = 6
    rng = np.random.default_rng(9)
    egos = jnp.asarray(
        np.array([100.0, -305.6, 4.0, 0.05])[None, :] + rng.normal(0, 0.2, (B, 4)))
    U0 = jnp.broadcast_to(solver.initial_controls(p, dtype=jnp.float64),
                          (B, p.horizon, 2))
    ob, um = _worlds(p, B, rng, jnp.float64)[world]
    assert not solver_batched.kernel_route(egos, ob)

    got = solver_batched.run_steps_batched(p, plan, n, egos, U0, ob, um)
    ob_ax = 0 if ob.pos.ndim == 4 else None
    um_ax = 0 if um.values.ndim == 3 else None
    want = jax.vmap(
        lambda e, u, o, m: solver.run_step(p, plan, n, e, u, o, m),
        in_axes=(0, 0, ob_ax, um_ax),
    )(egos, U0, ob, um)
    np.testing.assert_array_equal(np.asarray(got.iterations),
                                  np.asarray(want.iterations))
    for name in ("X", "U", "J", "lamb"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=1e-9, atol=1e-9, err_msg=name)


def test_cpu_backend_never_reaches_a_kernel(params, global_plan, monkeypatch):
    """On the CPU every batched entry point takes the XLA route: the GPU
    kernels are never called, so nothing runs in interpret mode unless a
    test asks for it."""
    from cilqr_tpu.ops import costmap, lm_pallas, uncertainty_pallas
    from cilqr_tpu.utils.params import CostmapParams

    def boom(*a, **k):
        raise AssertionError("a GPU kernel was reached on the CPU backend")

    monkeypatch.setattr(lm_pallas, "fused_optimize", boom)
    monkeypatch.setattr(uncertainty_pallas, "propagate_batched", boom)

    p = dataclasses.replace(params, horizon=4, max_iterations=2,
                            num_of_local_wpts=8, closest_point_samples_per_wpt=5)
    plan, n = rp.pad_global_plan(p, global_plan, dtype=jnp.float32)
    egos = jnp.asarray([[100.0, -305.6, 4.0, 0.05]] * 3, jnp.float32)
    U0 = jnp.broadcast_to(solver.initial_controls(p, dtype=jnp.float32),
                          (3, p.horizon, 2))
    assert not solver_batched.kernel_route(egos)
    res = solver_batched.run_steps_batched(p, plan, n, egos, U0)
    assert np.isfinite(np.asarray(res.U)).all()

    cp = dataclasses.replace(CostmapParams(), rows=8, cols=8, window_radius=2)
    prior = jnp.ones((8, 8), jnp.float32)
    geom = gridmap.make_geom([2.0, 0.0], cp.resolution, 8, 8, dtype=jnp.float32)
    assert not costmap.kernel_route(prior.dtype)
    out = costmap.propagate_uncertainty_batched(
        cp, prior, geom, jnp.zeros(3, jnp.float32))
    assert out.shape == (3, 8, 8)
