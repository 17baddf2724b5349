"""Baseline planners: Frenet lattice (3 uncertainty modes) and CCNMPC.

The reference ships only run instructions for these algorithms
(`Frenet/readme.md`, `CCNMPC/readme.md`); these tests lock the JAX
implementations that complete the batch_dataprocess.py comparison axis.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilqr_tpu.models import ccnmpc, frenet, obstacles as obs_mod
from cilqr_tpu.models import reference_path as rp, solver
from cilqr_tpu.sim import runner, scenarios
from cilqr_tpu.utils.params import NoiseParams, SolverParams


# ------------------------------------------------------------- polynomials
def test_quintic_boundary_conditions():
    T = jnp.asarray(3.0)
    p0, v0, a0, p1, v1, a1 = 0.5, 1.2, -0.3, 2.0, 0.0, 0.0
    b3, b4, b5 = frenet._quintic(T, p0, v0, a0, p1, v1, a1)

    def d(tau):
        return p0 + v0 * T * tau + 0.5 * a0 * T**2 * tau**2 + b3 * tau**3 + b4 * tau**4 + b5 * tau**5

    eps = 1e-6
    assert abs(float(d(1.0)) - p1) < 1e-9
    # velocity: (1/T) dd/dtau at tau=1
    v_end = (float(d(1.0)) - float(d(1.0 - eps))) / (eps * float(T))
    assert abs(v_end - v1) < 1e-4
    a_end = (float(d(1.0)) - 2 * float(d(1.0 - eps)) + float(d(1.0 - 2 * eps))) / (
        eps**2 * float(T) ** 2
    )
    assert abs(a_end - a1) < 1e-2


def test_quartic_boundary_conditions():
    T = jnp.asarray(2.5)
    p0, v0, a0, v1, a1 = 10.0, 4.0, 0.5, 6.0, 0.0
    b3, b4 = frenet._quartic(T, p0, v0, a0, v1, a1)

    def s(tau):
        return p0 + v0 * T * tau + 0.5 * a0 * T**2 * tau**2 + b3 * tau**3 + b4 * tau**4

    eps = 1e-6
    v_end = (float(s(1.0)) - float(s(1.0 - eps))) / (eps * float(T))
    assert abs(v_end - v1) < 1e-4
    a_end = (float(s(1.0)) - 2 * float(s(1.0 - eps)) + float(s(1.0 - 2 * eps))) / (
        eps**2 * float(T) ** 2
    )
    assert abs(a_end - a1) < 1e-2


def test_jerk_integral_matches_quadrature():
    T = 2.0
    b3, b4, b5 = 0.7, -0.3, 0.11
    got = float(frenet._jerk_integral(jnp.asarray(T), 0.0, jnp.asarray(b3),
                                      jnp.asarray(b4), jnp.asarray(b5)))
    tau = np.linspace(0, 1, 20001)
    jerk = (6 * b3 + 24 * b4 * tau + 60 * b5 * tau**2) / T**3
    want = float(np.trapezoid(jerk**2, tau) * T)
    assert abs(got - want) < 1e-6 * max(1.0, abs(want))


# ------------------------------------------------------------- frenet frame
@pytest.fixture(scope="module")
def lane_setup():
    p = SolverParams()
    plan_np = scenarios.straight_lane_plan()
    plan, n = rp.pad_global_plan(p, plan_np, dtype=jnp.float64)
    return p, plan, n


def test_projection_on_line(lane_setup):
    p, plan, n = lane_setup
    ego = jnp.asarray([100.0, -306.74, 4.0, 0.0])  # exactly on the lane
    lp = rp.get_local_plan(p, plan, n, ego)
    ref = frenet._ref_line(lp)
    s0, d0, th = frenet._project(ref, ego[:2])
    assert abs(float(d0)) < 1e-6
    assert abs(float(th)) < 1e-6
    # 1 m left of the lane (lane heads +x, left = +y)
    _, d1, _ = frenet._project(ref, jnp.asarray([100.0, -305.74]))
    assert abs(float(d1) - 1.0) < 1e-6


def test_frenet_plan_basic(lane_setup):
    p, plan, n = lane_setup
    fp = frenet.FrenetParams()
    ego = jnp.asarray([100.0, -306.5, 4.0, 0.02])
    res = jax.jit(lambda e: frenet.plan_step(p, fp, plan, n, e))(ego)
    X = np.asarray(res.X)
    assert np.isfinite(X).all()
    assert float(res.lamb) == 1.0                    # something feasible
    assert X[-1, 0] > X[0, 0] + 5.0                  # forward progress
    assert res.U.shape == (p.horizon, 2)
    # starts at the ego state
    np.testing.assert_allclose(X[0], np.asarray(ego), atol=1e-6)
    # tracks toward the lane: final offset smaller than initial
    assert abs(X[-1, 1] + 306.74) <= abs(X[0, 1] + 306.74) + 1e-6


def test_frenet_avoids_obstacle(lane_setup):
    p, plan, n = lane_setup
    fp = frenet.FrenetParams()
    ego = jnp.asarray([100.0, -306.74, 5.0, 0.0])
    ob = obs_mod.make_static_obstacles(
        p, [[115.0, -306.74]], [[4.8, 2.0]], [0.0], dtype=jnp.float64)
    res = jax.jit(lambda e: frenet.plan_step(p, fp, plan, n, e, ob))(ego)
    assert float(res.lamb) == 1.0
    X = np.asarray(res.X)
    d = np.hypot(X[:, 0] - 115.0, X[:, 1] + 306.74)
    # clearance at least the front-disc inflated half-width
    assert d.min() > 2.0


def test_frenet_expansion_more_conservative(lane_setup):
    # obstacle 3.4 m beside the lane: inside the expansion-inflated safety
    # ellipse (b ~ 2.85 + 2.4477*0.5 ~ 4.07) but outside the origin one
    # (b ~ 2.85), so origin keeps the lane while expansion must shy away.
    p, plan, n = lane_setup
    ego = jnp.asarray([100.0, -306.74, 5.0, 0.0])
    ob = obs_mod.make_static_obstacles(
        p, [[115.0, -306.74 + 3.4]], [[4.8, 2.0]], [0.0], dtype=jnp.float64)
    sig = jnp.asarray([0.5, 0.5, 0.02])

    def min_dist(mode):
        fp = frenet.FrenetParams(mode=mode)
        res = jax.jit(
            lambda e: frenet.plan_step(p, fp, plan, n, e, ob, sigmas=sig)
        )(ego)
        assert float(res.lamb) == 1.0
        X = np.asarray(res.X)
        return np.hypot(X[:, 0] - 115.0, X[:, 1] + 306.74 - 3.4).min()

    assert min_dist("expansion") > min_dist("origin") + 0.3


def test_frenet_propagation_avoids_uncertain_region(lane_setup):
    from cilqr_tpu.models import uncertainty as unc_mod

    p, plan, n = lane_setup
    ego = jnp.asarray([100.0, -306.74, 5.0, 0.0])
    # map frame = ego frame at build time; a high-occupancy blob straight
    # ahead on the lane (x local ~ +12 m)
    vals = np.zeros((40, 40), np.float64)
    vals[18:24, 22:30] = 100.0  # rows = y in [-1.2, 1.2]-ish, cols = x
    um = unc_mod.make_uncertainty_map(
        jnp.asarray(vals), center_xy=[10.0, 0.0], resolution=0.5,
        origin_xy=ego[:2], origin_yaw=ego[3], dtype=jnp.float64)

    fp = frenet.FrenetParams(mode="propagation")
    res = jax.jit(
        lambda e: frenet.plan_step(p, fp, plan, n, e, unc_map=um)
    )(ego)
    assert float(res.lamb) == 1.0
    # sample the map along the winning trajectory: must stay under threshold
    X = np.asarray(res.X)
    local = X[:, :2] - np.asarray(ego[:2])
    from cilqr_tpu.ops import gridmap

    u, _ = gridmap.sample_bilinear_with_grad(
        jnp.asarray(vals), um.geom, jnp.asarray(local))
    inside = np.asarray(gridmap.in_bounds(um.geom, jnp.asarray(local)))
    u = np.where(inside, np.asarray(u), 0.0)
    assert u.max() < fp.unc_threshold


def test_frenet_blocked_corridor_brakes(lane_setup):
    """With braking candidates in the lattice (v_frac_min=0) a blocked-but-
    distant wall selects a feasible stopping maneuver."""
    p, plan, n = lane_setup
    ys = np.linspace(-306.74 - 4.0, -306.74 + 4.0, 5)
    ob = obs_mod.make_static_obstacles(
        p, [[112.0, y] for y in ys], [[4.8, 2.0]] * 5, [0.0] * 5,
        dtype=jnp.float64)
    ego = jnp.asarray([100.0, -306.74, 5.0, 0.0])
    res = jax.jit(lambda e: frenet.plan_step(p, frenet.FrenetParams(), plan, n, e, ob))(ego)
    assert float(res.lamb) == 1.0          # a stop maneuver is feasible
    X = np.asarray(res.X)
    assert X[-1, 2] < 1.0                  # ... and it brakes
    assert X[:, 0].max() < 112.0 - 2.4     # never reaches the wall


def test_frenet_infeasible_fallback_emergency_brake(lane_setup):
    """Inside the inflated safety set of a wall, nothing is feasible — the
    fallback is a max-deceleration straight-line stop, not the least-cost
    colliding candidate."""
    p, plan, n = lane_setup
    ys = np.linspace(-306.74 - 4.0, -306.74 + 4.0, 5)
    ob = obs_mod.make_static_obstacles(
        p, [[112.0, y] for y in ys], [[4.8, 2.0]] * 5, [0.0] * 5,
        dtype=jnp.float64)
    ego = jnp.asarray([109.0, -306.74, 5.0, 0.0])
    res = jax.jit(lambda e: frenet.plan_step(p, frenet.FrenetParams(), plan, n, e, ob))(ego)
    assert float(res.lamb) == 0.0          # flagged infeasible
    X = np.asarray(res.X)
    assert np.isfinite(X).all()
    assert X[-1, 2] == 0.0                 # brakes to a stop
    np.testing.assert_allclose(X[:, 3], 0.0, atol=1e-9)  # straight line
    assert float(res.U[0, 0]) <= p.acc_min + 1e-6


def test_frenet_emitted_controls_feasible(lane_setup):
    """The recorded U never claims infeasible actuation: acc within the box,
    yaw-rate within the state-dependent bound v*tan(steer_max)/L evaluated
    at each step's speed (Model.cpp:19-20 semantics)."""
    p, plan, n = lane_setup
    ob = obs_mod.make_static_obstacles(
        p, [[112.0, -306.74]], [[4.8, 2.0]], [0.0], dtype=jnp.float64)
    # aggressive initial condition: fast, offset and misaligned -> the raw
    # finite-difference controls of the winning swerve exceed the bounds
    ego = jnp.asarray([100.0, -304.0, 8.0, -0.5])
    for obstacles in (None, ob):
        res = jax.jit(
            lambda e: frenet.plan_step(p, frenet.FrenetParams(), plan, n, e, obstacles)
        )(ego)
        U = np.asarray(res.U)
        X = np.asarray(res.X)
        assert (U[:, 0] >= p.acc_min - 1e-9).all()
        assert (U[:, 0] <= p.acc_max + 1e-9).all()
        bound = X[:-1, 2] * np.tan(p.steer_angle_max) / p.wheelbase
        assert (np.abs(U[:, 1]) <= bound + 1e-9).all()


def test_frenet_expansion_requires_sigmas(lane_setup):
    p, plan, n = lane_setup
    ob = obs_mod.make_static_obstacles(p, [[115.0, -306.0]], [[4.8, 2.0]], [0.0],
                                       dtype=jnp.float64)
    with pytest.raises(ValueError):
        frenet.plan_step(
            p, frenet.FrenetParams(mode="expansion"), plan, n,
            jnp.asarray([100.0, -306.74, 5.0, 0.0]), ob)


def test_frenet_bad_mode_rejected():
    with pytest.raises(ValueError):
        frenet.FrenetParams(mode="bogus")


# ------------------------------------------------------------------ ccnmpc
def test_covariance_propagation_vs_numpy(lane_setup):
    p, _, _ = lane_setup
    rng = np.random.default_rng(0)
    U = jnp.asarray(rng.uniform(-0.5, 0.5, (8, 2)))
    x0 = jnp.asarray([100.0, -306.0, 4.0, 0.05])
    from cilqr_tpu.models import dynamics

    X = dynamics.rollout(p, x0, U)
    W = ccnmpc.process_noise(NoiseParams(0.1, 0.2, 0.01), jnp.float64)
    S0 = 0.5 * W
    got = np.asarray(ccnmpc.propagate_covariance(p, X, U, S0, W))

    fx, _ = dynamics.jacobians(p, X[:-1, 2], X[:-1, 3], U[:, 0])
    fx = np.asarray(fx)
    want = [np.asarray(S0)]
    for k in range(8):
        want.append(fx[k] @ want[-1] @ fx[k].T + np.asarray(W))
    np.testing.assert_allclose(got, np.stack(want), atol=1e-12)
    # covariance grows along the horizon (positive process noise)
    assert np.trace(got[-1]) > np.trace(got[0])


def test_kappa_monotone_and_analytic():
    # chi2_2 quantile: 1 - exp(-x/2) = 1 - delta  =>  x = -2 ln(delta)
    assert abs(ccnmpc.CCParams(delta=0.05).kappa - 2.4477468) < 1e-6
    assert ccnmpc.CCParams(delta=0.01).kappa > ccnmpc.CCParams(delta=0.1).kappa


def test_tightened_obstacles_grow(lane_setup):
    p, _, _ = lane_setup
    ob = obs_mod.make_static_obstacles(
        p, [[10.0, 0.0]], [[4.0, 2.0]], [0.7], dtype=jnp.float64)
    S = jnp.broadcast_to(jnp.eye(4) * 0.04, (p.horizon + 1, 4, 4))
    ob_t = ccnmpc.tightened_obstacles(p, ccnmpc.CCParams(), ob, S)
    grow = np.asarray(ob_t.dims - ob.dims)[0]
    # isotropic 0.2-sigma: growth = 2 * kappa * 0.2 on both axes at every step
    np.testing.assert_allclose(grow, 2 * ccnmpc.CCParams().kappa * 0.2, atol=1e-9)
    # pose/mask untouched
    np.testing.assert_array_equal(np.asarray(ob_t.pos), np.asarray(ob.pos))


def test_ccnmpc_more_conservative_than_base(lane_setup):
    p0, plan, n = lane_setup
    p = dataclasses.replace(p0, horizon=20, max_iterations=8)
    ego = jnp.asarray([100.0, -305.6, 4.0, 0.05])
    ob = obs_mod.make_static_obstacles(
        p, [[120.0, -306.0]], [[4.8, 2.0]], [0.0], dtype=jnp.float64)
    U0 = solver.initial_controls(p, dtype=jnp.float64)
    noise = NoiseParams()

    res_cc = jax.jit(
        lambda e: ccnmpc.run_step(p, ccnmpc.CCParams(), noise, plan, n, e, U0, ob)
    )(ego)
    res_b = jax.jit(lambda e: solver.run_step(p, plan, n, e, U0, ob, None))(ego)

    def mind(res):
        X = np.asarray(res.X)
        return np.hypot(X[:, 0] - 120.0, X[:, 1] + 306.0).min()

    assert np.isfinite(np.asarray(res_cc.X)).all()
    assert mind(res_cc) >= mind(res_b) - 1e-6


def test_ccnmpc_sigma_zero_matches_base(lane_setup):
    p0, plan, n = lane_setup
    p = dataclasses.replace(p0, horizon=15, max_iterations=6)
    ego = jnp.asarray([100.0, -305.6, 4.0, 0.05])
    ob = obs_mod.make_static_obstacles(
        p, [[120.0, -306.0]], [[4.8, 2.0]], [0.0], dtype=jnp.float64)
    U0 = solver.initial_controls(p, dtype=jnp.float64)
    # n_sqp=1: with sigma=0 the tightening is exactly zero and a single
    # solve must match the base CILQR bit-for-bit (n_sqp=2 would warm-start
    # a second solve and legitimately land on a slightly different LM path)
    res_cc = ccnmpc.run_step(
        p, ccnmpc.CCParams(n_sqp=1), NoiseParams(0.0, 0.0, 0.0), plan, n, ego, U0, ob)
    res_b = solver.run_step(p, plan, n, ego, U0, ob, None)
    np.testing.assert_allclose(np.asarray(res_cc.U), np.asarray(res_b.U), atol=1e-9)


# ------------------------------------------------------- comparison runner
@pytest.mark.slow
def test_algorithm_comparison_grid(global_plan, tmp_path):
    p = dataclasses.replace(SolverParams(), horizon=10, max_iterations=4)
    sc = scenarios.Scenario("cmp", np.array([[120.0, -305.0, 0.0]]))
    results, rows = runner.run_algorithm_comparison(
        p, NoiseParams(0.05, 0.05, 0.005), global_plan,
        np.array([100.0, -305.6, 4.0, 0.05]), n_cycles=4,
        scenario=sc, algorithms=("cilqr", "ccnmpc", "frenet_origin"),
        n_runs=2, dtype=jnp.float64,
    )
    assert set(results) == {"cilqr", "ccnmpc", "frenet_origin"}
    assert len(rows) == 6
    assert all(np.isfinite(r["velocity_mean"]) for r in rows)
    from cilqr_tpu.utils import metrics

    metrics.export_csv(rows, str(tmp_path / "cmp.csv"))
    text = (tmp_path / "cmp.csv").read_text()
    assert "algorithm" in text.splitlines()[0]
    assert "frenet_origin" in text


def test_unknown_algorithm_rejected(lane_setup):
    p, plan, n = lane_setup
    with pytest.raises(ValueError):
        runner.make_plan_step("rrt", p, NoiseParams(), plan, n)


@pytest.mark.slow
def test_full_stack_comparison_differentiates(global_plan):
    """With per-cycle costmaps, `cilqr` and `cilqr_base` actually diverge
    (without them the uncertainty term has nothing to consume)."""
    from cilqr_tpu.ops import gridmap
    from cilqr_tpu.utils.params import CostmapParams

    # horizon 40 so the planned trajectory tail (~16 m ahead) reaches into
    # the corridor costmap, which sits ~12 m ahead of the ego
    p = dataclasses.replace(SolverParams(), max_iterations=4)
    cp = dataclasses.replace(CostmapParams(), rows=32, cols=48, window_radius=4)
    ggeom = gridmap.make_geom([130.0, -280.0], 1.0, 128, 128, dtype=jnp.float64)
    # occupied block butting the lane just ahead of the ego (placed via the
    # geometry helper — no index-convention guessing)
    xs, ys = gridmap.cell_positions(ggeom, 128, 128)  # (rows,), (cols,)
    gm = np.where(
        ((np.asarray(xs) > 103) & (np.asarray(xs) < 118))[:, None]
        & ((np.asarray(ys) > -307.5) & (np.asarray(ys) < -303.0))[None, :],
        90.0, 0.0)
    sc = scenarios.Scenario("fs", np.array([[120.0, -305.0, 0.0]]))

    outs = {}
    for algo in ("cilqr", "cilqr_base"):
        out, rows = runner.run_experiment_batch(
            p, NoiseParams(0.05, 0.05, 0.005), global_plan,
            np.array([100.0, -305.6, 4.0, 0.05]), n_cycles=3,
            scenario=sc, n_runs=1, dtype=jnp.float64, algorithm=algo,
            costmap_params=cp, global_map=jnp.asarray(gm), global_geom=ggeom,
        )
        assert all(np.isfinite(r["velocity_mean"]) for r in rows)
        outs[algo] = out["record"]["noisy_pos"]
    # same seeds, same noise — any trajectory difference comes from the
    # uncertainty-map term (cilqr consumes it, cilqr_base discards it)
    assert not np.allclose(np.asarray(outs["cilqr"]),
                           np.asarray(outs["cilqr_base"]))


def test_project_returns_reference_sample_exactly():
    """frenet._project reads the nearest sample with an index, so (s, d) of
    a point on a sample are exact (no product that a GPU may run in TF32)."""
    from cilqr_tpu.models import frenet

    s = jnp.linspace(0.0, 40.0, 81)
    ref = frenet._RefLine(s, 100.0 + s, -300.0 + 0.1 * s,
                          jnp.ones_like(s), jnp.zeros_like(s))
    i = 37
    s0, d0, yaw = frenet._project(ref, jnp.stack([ref.x[i], ref.y[i]]))
    assert float(s0) == float(ref.s[i]) and float(d0) == 0.0 and float(yaw) == 0.0
