"""Propagation kernel (ops/uncertainty_pallas) in interpret mode vs the XLA
reference, and the band plan that sets its windows (ops/costmap)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilqr_tpu.ops import costmap, gridmap, uncertainty_pallas
from cilqr_tpu.utils.params import CostmapParams

# float32 kernel vs float32 XLA reference: the kernel multiplies by 1/sigma
# where the reference divides, so weights differ in the last bits
RTOL, ATOL = 2e-5, 2e-4


@pytest.mark.parametrize("yaw", [0.0, 2.1])
@pytest.mark.parametrize("banded", [False, True])
def test_kernel_matches_reference_shared_prior(yaw, banded):
    """Per-scenario sigmas over one shared prior (the Monte-Carlo layout);
    with and without the band plan's per-band windows and disc cut."""
    cp = dataclasses.replace(CostmapParams(), rows=40, cols=20, window_radius=12)
    rng = np.random.default_rng(5)
    prior = jnp.asarray(rng.uniform(0, 100, (40, 20)), jnp.float32)
    geom = gridmap.make_geom([4.0, 0.0], cp.resolution, 40, 20, dtype=jnp.float32)
    yaw = jnp.asarray(yaw, jnp.float32)
    sigma_hi = (0.16, 0.16, 0.017)
    sigmas = jnp.asarray(np.concatenate(
        [rng.uniform(0.005, 0.16, (3, 2)), rng.uniform(0.005, 0.017, (3, 1))],
        axis=1), jnp.float32)
    plan = costmap.make_band_plan(cp, 40, 20, (4.0, 0.0), sigma_hi) if banded else None

    got = uncertainty_pallas.propagate_batched(
        cp, prior, geom, yaw, sigmas, plan, interpret=True)
    want = jax.vmap(lambda sg: costmap.propagate_uncertainty_reference(
        cp, prior, geom, yaw, sigmas=(sg[0], sg[1], sg[2])))(sigmas)
    assert got.shape == (3, 40, 20)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    # scenarios must actually differ (per-sigma fields reach the kernel)
    assert float(jnp.max(jnp.abs(got[0] - got[-1]))) > 1e-3


def test_kernel_matches_reference_per_scenario_prior_and_frame():
    """Full-stack layout: every scenario has its own prior, geometry center
    and yaw (sigmas from cp defaults); 20x18 is not a tile multiple."""
    cp = dataclasses.replace(CostmapParams(), rows=20, cols=18, window_radius=5)
    rng = np.random.default_rng(3)
    B = 3
    priors = jnp.asarray(rng.uniform(0, 100, (B, 20, 18)), jnp.float32)
    centers = jnp.asarray([[3.0, 0.0], [4.0, 0.5], [2.5, -0.5]], jnp.float32)
    geoms = jax.vmap(
        lambda c: gridmap.make_geom(c, cp.resolution, 20, 18, dtype=jnp.float32)
    )(centers)
    yaws = jnp.asarray([0.1, 0.5, -0.3], jnp.float32)

    got = uncertainty_pallas.propagate_batched(
        cp, priors, geoms, yaws, None, None, interpret=True)
    want = costmap.propagate_uncertainty_batched(cp, priors, geoms, yaws)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_tile_tables_take_the_largest_band_per_tile():
    plan = costmap.BandPlan(((0, 6, 3), (6, 10, 7), (16, 4, 2)), None,
                            disc_radii=(2.5, 6.5, 1.5))
    radius, disc2 = uncertainty_pallas.tile_tables(plan, 20, 12)
    # row tiles of 8: [0, 8) spans bands 0-1, [8, 16) band 1, [16, 20) band 2
    np.testing.assert_array_equal(radius, [7, 7, 2])
    np.testing.assert_allclose(disc2, [6.5**2, 6.5**2, 1.5**2])
    radius, disc2 = uncertainty_pallas.tile_tables(None, 20, 12)
    np.testing.assert_array_equal(radius, [12, 12, 12])
    np.testing.assert_allclose(disc2, [288.0] * 3)


def test_band_plan_validation():
    plan = costmap.BandPlan(((0, 8, 3), (9, 8, 3)), None)
    with pytest.raises(ValueError, match="not contiguous"):
        costmap.check_band_plan(plan, 17)
    with pytest.raises(ValueError, match="covers 16 rows"):
        costmap.check_band_plan(costmap.BandPlan(((0, 16, 3),), None), 20)


def test_band_plan_bounds_radii_cover_required():
    """Per-band radii dominate required_window_radius at the worst center
    of the interval (sampled check); default bands are 8 rows."""
    cp = dataclasses.replace(CostmapParams(), rows=64, cols=32)
    sigma_hi = (0.16, 0.16, 0.017)
    x_range, y_range = (-2.0, 18.0), (-4.0, 4.0)
    assert all(br == 8 for _, br, _ in costmap.make_band_plan_bounds(
        cp, 64, 32, x_range, y_range, sigma_hi).bands)
    plan = costmap.make_band_plan_bounds(
        cp, 64, 32, x_range, y_range, sigma_hi, max_bands=4
    )
    res = cp.resolution
    for cx in np.linspace(*x_range, 7):
        for cy in np.linspace(*y_range, 5):
            first_x = cx + 0.5 * 64 * res - 0.5 * res
            y_edge = abs(cy) + 0.5 * 32 * res - 0.5 * res
            for (r0, br, R) in plan.bands:
                xs = first_x - res * np.arange(r0, r0 + br)
                lever = np.hypot(np.abs(xs), y_edge).max()
                need = np.ceil(
                    cp.chisquare_val
                    * np.sqrt(sigma_hi[0] ** 2 + sigma_hi[1] ** 2
                              + sigma_hi[2] ** 2 * lever ** 2) / res
                )
                assert R >= need, (cx, cy, r0, R, need)


def test_band_plan_bounds_exact_over_center_interval():
    """Bounded band plan (per-scenario frames, the full-stack layout) equals
    the full-window kernel for every center inside the plan's interval."""
    cp = dataclasses.replace(CostmapParams(), rows=40, cols=20, window_radius=12,
                             sigma_x=0.05, sigma_y=0.05, sigma_theta=0.03)
    rng = np.random.default_rng(11)
    B = 4
    priors = jnp.asarray(rng.uniform(0, 100, (B, 40, 20)), jnp.float32)
    x_range, y_range = (1.0, 5.0), (-1.0, 1.0)
    centers = jnp.asarray(
        np.stack([rng.uniform(*x_range, B), rng.uniform(*y_range, B)], -1),
        jnp.float32,
    )
    geoms = jax.vmap(
        lambda c: gridmap.make_geom(c, cp.resolution, 40, 20, dtype=jnp.float32)
    )(centers)
    yaws = jnp.asarray(rng.uniform(-3.0, 3.0, B), jnp.float32)

    plan = costmap.make_band_plan_bounds(
        cp, 40, 20, x_range, y_range, (cp.sigma_x, cp.sigma_y, cp.sigma_theta))
    assert min(r for _, _, r in plan.bands) < max(r for _, _, r in plan.bands)
    banded = uncertainty_pallas.propagate_batched(
        cp, priors, geoms, yaws, None, plan, interpret=True)
    full = uncertainty_pallas.propagate_batched(
        cp, priors, geoms, yaws, None, None, interpret=True)
    np.testing.assert_array_equal(np.asarray(banded), np.asarray(full))
