"""Failure-mode behavior: barrier overflow, degenerate inputs, batched loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cilqr_tpu.models import obstacles as obs_mod, reference_path as rp, solver
from cilqr_tpu.sim import plant
from cilqr_tpu.utils.params import NoiseParams
import pytest


def test_solver_survives_barrier_overflow(params, global_plan):
    """Ego starting *inside* an obstacle: the f32 barrier overflows to inf,
    the backward pass goes non-finite, every candidate is rejected (NaN < J
    is false), lambda escalates and the loop aborts — the result must be the
    finite initial rollout, never NaN (the analog of the reference's
    eigensolver-failure abort, iLQR.cpp:159-162,233-236)."""
    p = dataclasses.replace(params, horizon=20)
    plan, n = rp.pad_global_plan(p, global_plan, dtype=jnp.float32)
    ego = jnp.asarray([115.0, -305.0, 2.0, 0.0], jnp.float32)  # on the obstacle
    ob = obs_mod.make_static_obstacles(
        p, [[115.0, -305.0]], [[3.63, 1.84]], [0.0], dtype=jnp.float32
    )
    res = solver.run_step_jit(
        p, plan, n, ego, solver.initial_controls(p, dtype=jnp.float32), obstacles=ob
    )
    assert np.isfinite(np.asarray(res.U)).all()
    assert np.isfinite(np.asarray(res.X)).all()


def test_solver_handles_two_point_plan(params):
    """Degenerate global plan (2 points): window clamps, polyfit degenerates
    to a near-constant — solve must stay finite."""
    p = dataclasses.replace(params, horizon=10, max_iterations=4)
    plan, n = rp.pad_global_plan(
        p, np.array([[0.0, 0.0], [1.0, 0.1]]), dtype=jnp.float64
    )
    res = solver.run_step_jit(
        p, plan, n, jnp.asarray([0.0, 0.0, 2.0, 0.0]), solver.initial_controls(p, dtype=jnp.float64)
    )
    assert np.isfinite(np.asarray(res.U)).all()


@pytest.mark.slow
def test_closed_loop_batched(params, global_plan):
    p = dataclasses.replace(params, horizon=8, max_iterations=3,
                            num_of_local_wpts=8, closest_point_samples_per_wpt=5)
    B = 100
    plan, n = rp.pad_global_plan(p, global_plan, dtype=jnp.float32)
    rng = np.random.default_rng(81)
    x0s = jnp.asarray(
        np.array([100.0, -305.6, 4.0, 0.05])[None, :] + rng.normal(0, 0.3, (B, 4)),
        jnp.float32,
    )

    xf, rec = plant.closed_loop_batched(
        p, NoiseParams(0.0, 0.0, 0.0), plan, n, x0s, jax.random.key(0), 5
    )
    assert xf.shape == (B, 4)
    assert rec["start_pos"].shape == (5, B, 4)
    assert np.isfinite(np.asarray(xf)).all()
    # forward progress on average
    assert float(jnp.mean(xf[:, 0] - x0s[:, 0])) > 1.0


@pytest.mark.parametrize(
    "route", ["run_step", "batched_xla", "kernel_interpret", "oracle_float64"])
def test_failed_backward_pass_keeps_trajectory(params, global_plan, route):
    """Non-finite gains (here from a NaN costmap; in float32 also from
    barrier Hessians that overflow the value recursion) end the solve with
    the current trajectory kept, lambda unchanged and ``failed`` set — the
    eigensolver-failure abort of iLQR.cpp:159-162 — on every route and in
    the float64 oracle.  Accepting them would return a NaN plan: J is
    evaluated on the pre-update trajectory, so the first iteration accepts
    whatever the backward pass produced."""
    from cilqr_tpu.models import dynamics, solver_batched, uncertainty as unc_mod
    from cilqr_tpu.ops import lm_pallas
    from oracle import oracle_cilqr as oracle

    p = dataclasses.replace(params, horizon=6, max_iterations=4,
                            num_of_local_wpts=8, closest_point_samples_per_wpt=5)
    egos_np = np.asarray([[100.0, -305.6, 4.0, 0.05], [100.3, -305.4, 4.2, 0.0]])
    nan_map = (np.full((24, 16), np.nan), [2.0, 0.0], 0.5, [100.0, -305.6], 0.05)
    U0 = jnp.broadcast_to(solver.initial_controls(p, dtype=jnp.float32),
                          (2, p.horizon, 2))
    if route == "oracle_float64":
        unc = oracle.OracleUncertainty(*nan_map)

        def solve(e):
            local_plan, coeffs = oracle.get_local_plan(p, np.asarray(global_plan), e)
            return oracle.optimize(p, e, np.asarray(U0[0], np.float64), coeffs,
                                   local_plan[:, 0], None, unc)

        X, U, it, J, lamb = (np.stack(a) for a in zip(*map(solve, egos_np)))
        failed = it == 1  # the oracle aborts without a flag
    else:
        plan, n = rp.pad_global_plan(p, global_plan, dtype=jnp.float32)
        egos = jnp.asarray(egos_np, jnp.float32)
        unc = unc_mod.make_uncertainty_map(*nan_map, dtype=jnp.float32)
        plans = jax.vmap(lambda e: rp.get_local_plan(p, plan, n, e))(egos)
        if route == "run_step":
            X, U, it, J, lamb, failed = jax.vmap(
                lambda pl_, e, u: solver.optimize(p, pl_, e, u, None, unc))(plans, egos, U0)
        elif route == "batched_xla":
            X, U, it, J, lamb, failed = solver_batched.batched_optimize(
                p, plans, egos, U0, None, unc)
        else:
            X, U, it, J, lamb, failed = lm_pallas.fused_optimize(
                p, plans, egos, U0, None, unc, interpret=True)
    want = jax.vmap(lambda e, u: dynamics.rollout(p, e, u))(
        jnp.asarray(egos_np, jnp.float32), U0)
    np.testing.assert_array_equal(np.asarray(U, np.float32), np.asarray(U0))
    np.testing.assert_allclose(np.asarray(X), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(it), 1)
    np.testing.assert_array_equal(np.asarray(lamb), p.lamb_init)
    np.testing.assert_array_equal(np.asarray(failed), True)
    assert np.isfinite(np.asarray(J)).all()
