"""Fused LM-solve kernel (ops/lm_pallas) in interpret mode vs the XLA route.

The Pallas interpreter runs the Triton-route kernel on the CPU; its
numerics match XLA's CPU code op for op except the sequentially summed J
(see the module docstring), so trajectories agree to float32 rounding.
The compiled kernel is compared with XLA on the card by
tests/test_gpu_chip.py and chip_smoke.py.
"""

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
from cilqr_tpu.ops import lm_pallas


def _setup(params, global_plan, B, horizon=6, max_iterations=3, seed=61):
    # small horizon and sample table (S = 8 * 5): interpret-mode cost is
    # trace + execution of the per-lane loops
    p = dataclasses.replace(
        params, horizon=horizon, max_iterations=max_iterations,
        num_of_local_wpts=8, closest_point_samples_per_wpt=5,
    )
    plan, n = rp.pad_global_plan(p, global_plan, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    egos = jnp.asarray(
        np.array([100.0, -305.6, 4.0, 0.05])[None, :] + rng.normal(0, 0.4, (B, 4)),
        jnp.float32,
    )
    U0 = jnp.broadcast_to(
        solver.initial_controls(p, dtype=jnp.float32), (B, p.horizon, 2)
    )
    plans = jax.vmap(lambda e: rp.get_local_plan(p, plan, n, e))(egos)
    return p, plans, egos, U0, rng


def _world(p, kind, egos, rng):
    B = egos.shape[0]
    if kind == "none":
        return None, None
    ob = obs_mod.make_static_obstacles(
        p, [[112.0, -305.5], [125.0, -304.6]], [[3.63, 1.84]] * 2, [0.0, 0.3],
        dtype=jnp.float32,
    )
    if kind == "shared":
        return ob, unc_mod.make_uncertainty_map(
            rng.uniform(0.0, 100.0, (48, 32)), [10.0, 0.0], 0.2,
            np.asarray(egos[0, :2]), float(egos[0, 3]), dtype=jnp.float32)
    maps = [
        unc_mod.make_uncertainty_map(
            rng.uniform(0.0, 100.0, (24, 16)), [5.0, 0.0], 0.25,
            np.asarray(egos[i, :2]), float(egos[i, 3]), dtype=jnp.float32)
        for i in range(B)
    ]
    return ob, jax.tree.map(lambda *a: jnp.stack(a), *maps)


@pytest.mark.parametrize("world", ["none", "shared", "per_scenario_maps"])
def test_kernel_matches_xla_route(params, global_plan, world):
    """B = 37: one program, its lanes 37.. padded with copies of lane 0."""
    p, plans, egos, U0, rng = _setup(params, global_plan, 37)
    ob, um = _world(p, world, egos, rng)
    got = lm_pallas.fused_optimize(p, plans, egos, U0, ob, um, interpret=True)
    want = solver_batched.batched_optimize(p, plans, egos, U0, ob, um)
    X, U, it, J, lamb, failed = (np.asarray(a) for a in got)
    assert X.shape == (37, p.horizon + 1, 4) and it.dtype == np.int32
    np.testing.assert_array_equal(it, np.asarray(want[2]))
    np.testing.assert_array_equal(lamb, np.asarray(want[4]))
    np.testing.assert_array_equal(failed, np.asarray(want[5]))
    np.testing.assert_allclose(X, np.asarray(want[0]), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(U, np.asarray(want[1]), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(J, np.asarray(want[3]), rtol=2e-6)


def test_padding_lanes_do_not_change_a_lane(params, global_plan):
    """B = 1 (one program of copies) and B = 5 give lane 0 the same solve:
    a lane's result does not depend on its block's co-tenants."""
    p, plans, egos, U0, rng = _setup(params, global_plan, 5, horizon=4,
                                     max_iterations=2, seed=11)
    ob, um = _world(p, "shared", egos, rng)
    five = lm_pallas.fused_optimize(p, plans, egos, U0, ob, um, interpret=True)
    one = lm_pallas.fused_optimize(
        p, jax.tree.map(lambda a: a[:1], plans), egos[:1], U0[:1], ob, um,
        interpret=True)
    for a, b in zip(one, five):
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert one[1].shape == (1, p.horizon, 2)


def test_absent_world_adds_exact_zeros(params):
    """No obstacles / no map: the payloads make every barrier term an exact
    zero, so one compiled kernel serves every world kind."""
    p = dataclasses.replace(params, horizon=4)
    obs = lm_pallas.prep_obstacles(p, None)
    assert obs.shape == (p.max_obstacles * 6, 4) and not np.asarray(obs).any()
    flat, frame = lm_pallas.prep_unc_map(None, 3)
    fr = np.asarray(frame)
    assert fr.shape == (lm_pallas.N_FRAME, 3) and (fr[7] > fr[8]).all()
    assert (fr[6] == 1.0).all()  # a finite resolution: no 0 * inf
    assert flat.shape == (4,) and (fr[11:13] == 1.0).all() and (fr[13] == 2.0).all()


def test_kernel_rejects_per_scenario_obstacles(params, global_plan):
    p, plans, egos, U0, rng = _setup(params, global_plan, 2)
    ob, _ = _world(p, "shared", egos, rng)
    ob_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape), ob)
    assert not solver_batched.kernel_route(egos, ob_b)
    with pytest.raises(ValueError, match="shared obstacles"):
        lm_pallas.fused_optimize(p, plans, egos, U0, ob_b, None, interpret=True)


def test_prep_obstacles_quadratic_form(params):
    """G = R^T diag(a^-2, b^-2) R reproduces Obstacle.cpp:39-112's c value."""
    p = dataclasses.replace(params, horizon=4)
    ob = obs_mod.make_static_obstacles(
        p, [[3.0, 1.0]], [[4.0, 2.0]], [0.7], speeds=[2.0], dtype=jnp.float32
    )
    payload = lm_pallas.prep_obstacles(p, ob)
    M = ob.dims.shape[0]
    assert payload.shape == (M * 6, p.horizon)
    g11, g12, g22, px, py, msk = (np.asarray(payload[i, 0]) for i in range(6))
    assert msk == 1.0 and px == 3.0 and py == 1.0

    # quadratic form vs the explicit rotate-then-scale reference math
    oth, ov = 0.7, 2.0
    a = 4.0 / 2 + abs(ov * np.cos(oth)) * p.t_safe + p.s_safe_a + p.ego_rad
    b = 2.0 / 2 + abs(ov * np.sin(oth)) * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
    for dxy in ([1.3, -0.4], [-2.0, 0.9]):
        dx = np.cos(oth) * dxy[0] + np.sin(oth) * dxy[1]
        dy = -np.sin(oth) * dxy[0] + np.cos(oth) * dxy[1]
        want = dx * dx / a**2 + dy * dy / b**2
        got = g11 * dxy[0] ** 2 + 2 * g12 * dxy[0] * dxy[1] + g22 * dxy[1] ** 2
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_prep_unc_map_flat_values_and_frame(params):
    """Shared maps broadcast one frame to every lane; per-scenario maps are
    laid out lane after lane for the in-kernel gather."""
    rng = np.random.default_rng(3)
    vals = rng.uniform(0, 100, (9, 7))
    unc = unc_mod.make_uncertainty_map(vals, [1.0, 0.5], 0.25, [2.0, -1.0], 0.3,
                                       dtype=jnp.float32)
    flat, frame = lm_pallas.prep_unc_map(unc, 4)
    np.testing.assert_array_equal(np.asarray(flat), vals.astype(np.float32).ravel())
    fr = np.asarray(frame)
    assert fr.shape == (lm_pallas.N_FRAME, 4)
    np.testing.assert_allclose(fr[:, 0], fr[:, 3])
    np.testing.assert_allclose(fr[:4, 0], [2.0, -1.0, np.cos(0.3), np.sin(0.3)],
                               rtol=1e-6)
    # first cell center = center + length/2 - res/2; bounds = center -+ length/2
    np.testing.assert_allclose(
        fr[4:, 0], [1.0 + 1.125 - 0.125, 0.5 + 0.875 - 0.125, 0.25,
                    1.0 - 1.125, 1.0 + 1.125, 0.5 - 0.875, 0.5 + 0.875,
                    8.0, 6.0, 7.0, 0.0],
        rtol=1e-6)

    two = jax.tree.map(lambda *a: jnp.stack(a), unc, unc._replace(
        values=unc.values + 1.0, origin_yaw=jnp.asarray(-0.2, jnp.float32)))
    flat, frame = lm_pallas.prep_unc_map(two, 2)
    assert flat.shape == (2 * 9 * 7,) and (np.asarray(frame[14]) == 63.0).all()
    np.testing.assert_allclose(np.asarray(flat[63:]) - np.asarray(flat[:63]), 1.0,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(frame[2]), np.cos([0.3, -0.2]), rtol=1e-6)
