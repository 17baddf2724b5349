"""GPU tier: the compiled GPU kernels against XLA's plain route on the card.

Run on a machine with the card: ``python -m pytest tests/ -m gpu``
(``chip_smoke.py`` runs it too).  Elsewhere every test here skips from its
fixture; the interpret-mode tests (test_lm_pallas.py,
test_uncertainty_pallas.py) cover the same math on the CPU, but only a
compiled run can catch a lowering fault.

Both sides run in float32 on the card, so the limits are those of two
summation orders, not of two precisions: ``chip_smoke.TOL``'s route_du and
route_dj, with at most ``MAX_FORK_LANES`` lanes apart (a lane at a fork
between local optima, or stopping one LM iteration earlier, settles apart
on two summation orders).
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

#: lanes of a 300-lane batch that may sit apart between the two routes
MAX_FORK_LANES = 3
#: chip_smoke.TOL["route_du"], ["route_dj"]
ROUTE_DU = ROUTE_DJ = 2e-3


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests/ -m gpu` on the card")
    return jax.devices()[0]


def _scenario(B, seed):
    import jax.numpy as jnp

    from cilqr_tpu.sim.example_scenario import example_scenario
    from cilqr_tpu.utils.params import SolverParams

    p = dataclasses.replace(SolverParams(), horizon=50)
    plan, n, ego, U0, obstacles, unc = example_scenario(p, jnp.float32)
    rng = np.random.default_rng(seed)
    egos = jnp.asarray(np.asarray(ego)[None] + rng.normal(0, 0.3, (B, 4)),
                       jnp.float32)
    U0s = jnp.broadcast_to(U0, (B,) + U0.shape)
    return p, plan, n, egos, U0s, obstacles, unc


@pytest.mark.parametrize("world", ["none", "shared", "per_scenario_maps"])
def test_lm_kernel_matches_xla_route(gpu, world):
    """B = 300 (five 64-lane programs, the last padded), N = 50, 200
    closest-point samples: the compiled kernel vs batched_optimize.  Every
    lane but at most MAX_FORK_LANES agrees to float32 summation order in the
    head of the plan (what receding horizon control applies) and in J."""
    import jax
    import jax.numpy as jnp

    from cilqr_tpu.models import reference_path as rp, solver_batched
    from cilqr_tpu.models import uncertainty as unc_mod
    from cilqr_tpu.ops import lm_pallas

    B = 300
    p, plan, n, egos, U0s, ob, unc = _scenario(B, 7)
    if world == "none":
        ob = unc = None
    elif world == "per_scenario_maps":
        rng = np.random.default_rng(8)
        vals = jnp.asarray(rng.uniform(0, 100, (B,) + unc.values.shape), jnp.float32)
        bc = lambda a: jnp.broadcast_to(a, (B,) + a.shape)
        unc = unc_mod.UncertaintyMap(vals, jax.tree.map(bc, unc.geom),
                                     bc(unc.origin_xy), bc(unc.origin_yaw))
    plans = jax.jit(jax.vmap(lambda e: rp.get_local_plan(p, plan, n, e)))(egos)
    got = jax.jit(lambda pl_, e, u: lm_pallas.fused_optimize(
        p, pl_, e, u, ob, unc))(plans, egos, U0s)
    want = jax.jit(lambda pl_, e, u: solver_batched.batched_optimize(
        p, pl_, e, u, ob, unc))(plans, egos, U0s)
    X, U, it, J, _, failed = (np.asarray(a) for a in got)
    Uw, Jw = np.asarray(want[1]), np.asarray(want[3])
    assert np.isfinite(X).all() and np.isfinite(U).all()
    assert it.min() >= 1 and it.max() <= p.max_iterations
    np.testing.assert_array_equal(failed, np.asarray(want[5]))
    head = np.abs(U[:, :10] - Uw[:, :10]).max(axis=(1, 2))
    dj = np.abs(J - Jw) / np.abs(Jw)
    apart = np.flatnonzero((head > ROUTE_DU) | (dj > ROUTE_DJ))
    print(f"{world}: lanes apart {apart.tolist()}, head {head[apart].tolist()}, "
          f"max head of the others {np.delete(head, apart).max():.2e}")
    assert apart.size <= MAX_FORK_LANES, (apart, head[apart], dj[apart])


def test_lm_kernel_b1_equals_lane_of_a_batch(gpu):
    """A lane's plan does not depend on the lanes beside it.  Within one
    compiled program (B = 5) lane 0 gives the same bits beside four other
    lanes as beside four copies of itself (the B = 1 padding).  The B = 1
    program itself is another XLA compilation (its plan fit may pick
    another cuBLAS algorithm), so it is held to the head tolerance."""
    import jax

    from cilqr_tpu.models import solver_batched

    p, plan, n, egos, U0s, ob, unc = _scenario(5, 9)
    f = jax.jit(lambda e, u: solver_batched.run_steps_batched(p, plan, n, e, u, ob, unc))
    assert solver_batched.kernel_route(egos, ob)
    five = f(egos, U0s)
    copies = f(jax.numpy.repeat(egos[:1], 5, axis=0), U0s)
    for got in (np.asarray(copies.U), np.asarray(copies.iterations)):
        for lane in range(5):
            np.testing.assert_array_equal(got[lane], got[0])
    np.testing.assert_array_equal(np.asarray(copies.U[0]), np.asarray(five.U[0]))
    np.testing.assert_array_equal(np.asarray(copies.iterations[0]),
                                  np.asarray(five.iterations[0]))
    one = f(egos[:1], U0s[:1])
    assert 1 <= int(one.iterations[0]) <= p.max_iterations
    head = np.abs(np.asarray(one.U[0, :10]) - np.asarray(five.U[0, :10])).max()
    assert head <= 2e-2, head


@pytest.mark.parametrize("layout", ["shared_prior", "per_scenario_prior"])
def test_propagation_kernel_matches_xla(gpu, layout):
    """Production geometry (152 x 104 cells, band plan at the Monte-Carlo
    sigma bound): the compiled kernel vs the vmapped XLA reference."""
    import jax
    import jax.numpy as jnp

    from cilqr_tpu.ops import costmap, gridmap, uncertainty_pallas
    from cilqr_tpu.parallel import monte_carlo as mc
    from cilqr_tpu.utils.params import CostmapParams

    sigma_hi = (0.16, 0.16, 0.017)
    cp = CostmapParams()
    center = (cp.x_position, cp.y_position)
    cp = mc.ensure_window_covers(cp, cp.rows, cp.cols, center, sigma_hi)
    band = costmap.make_band_plan_bounds(
        cp, cp.rows, cp.cols, (center[0] - 1, center[0] + 1), (-1.0, 1.0), sigma_hi)
    rng = np.random.default_rng(3)
    B = 64
    sig = jnp.asarray(np.concatenate(
        [rng.uniform(0.02, 0.16, (B, 2)), rng.uniform(0.005, 0.017, (B, 1))], 1),
        jnp.float32)
    if layout == "shared_prior":
        prior = jnp.asarray(rng.uniform(0, 100, (cp.rows, cp.cols)), jnp.float32)
        geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols,
                                 dtype=jnp.float32)
        yaw = jnp.asarray(0.3, jnp.float32)
    else:
        prior = jnp.asarray(rng.uniform(0, 100, (B, cp.rows, cp.cols)), jnp.float32)
        cs = jnp.asarray(np.asarray(center) + rng.uniform(-1, 1, (B, 2)), jnp.float32)
        geom = jax.vmap(lambda c: gridmap.make_geom(
            c, cp.resolution, cp.rows, cp.cols, dtype=jnp.float32))(cs)
        yaw = jnp.asarray(rng.uniform(-3, 3, B), jnp.float32)
    got = jax.jit(lambda s: uncertainty_pallas.propagate_batched(
        cp, prior, geom, yaw, s, band))(sig)
    pr_ax = 0 if prior.ndim == 3 else None
    g_ax = 0 if geom.center.ndim == 2 else None
    y_ax = 0 if yaw.ndim == 1 else None
    want = jax.jit(jax.vmap(
        lambda pr, g, y, s: costmap.propagate_uncertainty_reference(
            cp, pr, g, y, sigmas=(s[0], s[1], s[2])),
        in_axes=(pr_ax, g_ax, y_ax, 0)))(prior, geom, yaw, sig)
    got = np.asarray(got)
    assert got.min() >= 0.0 and got.max() <= 100.0
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=5e-4)
