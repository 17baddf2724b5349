"""Costmap engine tests: gridmap math, rasterization, uncertainty propagation."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from cilqr_tpu.ops import costmap, gridmap
from cilqr_tpu.utils.params import CostmapParams
from oracle import oracle_costmap


def small_costmap_params(**kw):
    base = dict(rows=24, cols=16, window_radius=8)
    base.update(kw)
    return dataclasses.replace(CostmapParams(), **base)


# ------------------------------------------------------------------ gridmap
def test_position_index_roundtrip():
    geom = gridmap.make_geom([3.0, -1.0], 0.2, 30, 20, dtype=jnp.float64)
    idx = jnp.stack(
        jnp.meshgrid(jnp.arange(30), jnp.arange(20), indexing="ij"), axis=-1
    )
    pos = gridmap.position_from_index(geom, idx)
    back = gridmap.index_from_position(geom, pos)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(idx))


def test_grid_orientation_matches_grid_map_convention():
    """Index (0,0) must sit at the (+x, +y) corner (GridMapMath semantics)."""
    geom = gridmap.make_geom([0.0, 0.0], 0.5, 4, 4, dtype=jnp.float64)
    p00 = gridmap.position_from_index(geom, jnp.array([0, 0]))
    p33 = gridmap.position_from_index(geom, jnp.array([3, 3]))
    assert p00[0] > p33[0] and p00[1] > p33[1]
    np.testing.assert_allclose(np.asarray(p00), [0.75, 0.75])


def test_polygon_rasterization_axis_aligned():
    geom = gridmap.make_geom([0.0, 0.0], 1.0, 8, 8, dtype=jnp.float64)
    verts = jnp.asarray([[-2.0, -2.0], [2.0, -2.0], [2.0, 2.0], [-2.0, 2.0]])
    mask = np.asarray(gridmap.rasterize_polygon(geom, 8, 8, verts))
    xs, ys = gridmap.cell_positions(geom, 8, 8)
    xs, ys = np.asarray(xs), np.asarray(ys)
    want = ((np.abs(xs)[:, None] <= 2.0) & (np.abs(ys)[None, :] <= 2.0)).astype(float)
    np.testing.assert_array_equal(mask, want)


def test_ellipse_mask_matches_quadratic_form():
    geom = gridmap.make_geom([0.0, 0.0], 0.25, 32, 32, dtype=jnp.float64)
    m = gridmap.ellipse_mask(
        geom, 32, 32, jnp.asarray([0.5, -0.25]), jnp.asarray([2.0, 1.0]), jnp.asarray(0.7)
    )
    xs, ys = gridmap.cell_positions(geom, 32, 32)
    xs, ys = np.asarray(xs), np.asarray(ys)
    dx = xs[:, None] - 0.5
    dy = ys[None, :] + 0.25
    c, s = np.cos(0.7), np.sin(0.7)
    u = c * dx + s * dy
    w = s * dx - c * dy
    want = (u / 2.0) ** 2 + (w / 1.0) ** 2 <= 1.0
    np.testing.assert_array_equal(np.asarray(m), want)


def test_bilinear_grad_matches_fd():
    rng = np.random.default_rng(5)
    data = jnp.asarray(rng.uniform(0, 100, (20, 20)))
    geom = gridmap.make_geom([0.0, 0.0], 0.2, 20, 20, dtype=jnp.float64)
    pts = jnp.asarray(rng.uniform(-1.5, 1.5, (50, 2)))
    val, grad = gridmap.sample_bilinear_with_grad(data, geom, pts)
    eps = 1e-6
    for k in range(2):
        e = np.zeros(2)
        e[k] = eps
        vp, _ = gridmap.sample_bilinear_with_grad(data, geom, pts + jnp.asarray(e))
        vm, _ = gridmap.sample_bilinear_with_grad(data, geom, pts - jnp.asarray(e))
        fd = (np.asarray(vp) - np.asarray(vm)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(grad[:, k]), fd, atol=1e-4)


# ------------------------------------------------------ uncertainty kernel
@pytest.mark.parametrize("yaw", [0.0, 0.9, 3.5])
@pytest.mark.parametrize("faithful", [False, True])
def test_propagation_matches_ellipse_iterator_oracle(yaw, faithful):
    """Fixed-window masked propagation == exact EllipseIterator semantics,
    in both the corrected-PSD and reference-faithful rho modes."""
    cp = small_costmap_params(sigma_x=0.08, sigma_y=0.06, sigma_theta=0.05)
    rng = np.random.default_rng(9)
    prior = rng.uniform(0, 100, (cp.rows, cp.cols))
    center = np.array([1.2, -0.4])

    need = costmap.required_window_radius(cp, cp.rows, cp.cols, center)
    assert need <= cp.window_radius, (need, cp.window_radius)

    geom = gridmap.make_geom(center, cp.resolution, cp.rows, cp.cols, dtype=jnp.float64)
    got = np.asarray(
        costmap.propagate_uncertainty_reference(
            cp, jnp.asarray(prior), geom, jnp.asarray(yaw), faithful_rho=faithful
        )
    )
    want = oracle_costmap.propagate(cp, prior, center, yaw, faithful_rho=faithful)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_propagation_tiny_sigma_is_identity_like():
    """With near-zero sigma the ellipse collapses to the center cell."""
    cp = small_costmap_params(sigma_x=1e-4, sigma_y=1e-4, sigma_theta=1e-6)
    rng = np.random.default_rng(10)
    prior = rng.uniform(0, 100, (cp.rows, cp.cols))
    geom = gridmap.make_geom([0.0, 0.0], cp.resolution, cp.rows, cp.cols, dtype=jnp.float64)
    got = np.asarray(
        costmap.propagate_uncertainty_reference(cp, jnp.asarray(prior), geom, jnp.asarray(0.3))
    )
    np.testing.assert_allclose(got, prior, atol=1e-6)


# --------------------------------------------------------------- full tick
@pytest.mark.slow
def test_build_local_costmap_pipeline(global_plan):
    # taller grid: the corridor-derived center sits ~2.6 m left of the lane
    # (8 m left / 4 m right corridor), so the map must span back to y~0
    cp = small_costmap_params(cols=48)
    rng = np.random.default_rng(13)
    gmap = jnp.asarray(rng.uniform(0, 100, (64, 64)))
    ggeom = gridmap.make_geom([100.0, -305.0], 2.0, 64, 64, dtype=jnp.float64)

    wpts = jnp.asarray(global_plan)
    ego = jnp.asarray([100.0, -305.6, 4.0, 0.05])
    # first obstacle ~15 m ahead of the ego — inside the corridor-centered
    # small test map (center x = x_len/2 - 5 ~ 15 m); second beyond the gate
    obs_xy = jnp.asarray([[115.0, -305.0], [500.0, 500.0]])
    obs_size = jnp.asarray([[3.63, 1.84], [3.63, 1.84]])
    obs_yaw = jnp.asarray([0.1, 0.0])
    obs_mask = jnp.asarray([1.0, 1.0])

    out = costmap.build_local_costmap(
        cp, gmap, ggeom, wpts, jnp.asarray(wpts.shape[0]), ego,
        obs_xy, obs_size, obs_yaw, obs_mask,
    )
    assert out.uncertainty_map.shape == (cp.rows, cp.cols)
    # obstacle 1 is in range -> some cells rasterized at 100; obstacle 2 is
    # beyond the 100 m gate -> contributes nothing
    assert float(jnp.max(out.bounding_box_map)) == 100.0
    assert np.isfinite(np.asarray(out.uncertainty_map)).all()
    # bbox cells override the prior in vehicle_map (local_costmap.cpp:260-263)
    bb = np.asarray(out.bounding_box_map) > 90
    np.testing.assert_allclose(np.asarray(out.vehicle_map)[bb], 100.0)
    # corridor mask is a valid 0/1 layer; the small test grid sits entirely
    # inside the ~40x12 m corridor bbox so full coverage is expected here
    cm = np.asarray(out.corridor_mask)
    assert 0 < cm.sum() <= cm.size and set(np.unique(cm)) <= {0.0, 1.0}


def test_corridor_geometry_moves_with_ego(global_plan):
    cp = small_costmap_params()
    wpts = jnp.asarray(global_plan)
    n = jnp.asarray(wpts.shape[0])
    c1, (xl1, yl1), bounds = costmap.corridor_geometry(
        cp, wpts, n, jnp.asarray([100.0, -305.6]), jnp.asarray(0.05)
    )
    c2, _, _ = costmap.corridor_geometry(
        cp, wpts, n, jnp.asarray([130.0, -304.0]), jnp.asarray(0.0)
    )
    assert float(bounds[1]) > float(bounds[0]) and float(bounds[3]) > float(bounds[2])
    assert np.isfinite(np.asarray(c1)).all() and np.isfinite(np.asarray(c2)).all()
    # corridor spans ~40 waypoints ahead plus 12 m laterally
    assert float(xl1) > 10.0 and float(yl1) >= 12.0


@pytest.mark.slow
def test_corridor_center_bounds_cover_route(global_plan):
    """The concrete center intervals cover every corridor geometry produced
    by egos scattered around the route (the full-stack batched scatter)."""
    import jax

    cp = small_costmap_params()
    wpts = jnp.asarray(global_plan)
    n = jnp.asarray(wpts.shape[0])
    (x_lo, x_hi), (y_lo, y_hi) = costmap.corridor_center_bounds(
        cp, wpts, wpts.shape[0]
    )
    assert x_lo < x_hi and y_lo < y_hi

    # the benchmark's actual scatter: N(0, 0.3) on x/y/yaw — include the
    # 4-sigma yaw tails explicitly (the corridor center ROTATES with yaw,
    # so tail yaws move it by ~half the 40 m look-ahead)
    rng = np.random.default_rng(7)
    S = 64
    idx = rng.integers(0, wpts.shape[0] - 1, S)
    base = np.asarray(global_plan)[idx]
    tang = np.asarray(global_plan)[np.minimum(idx + 1, wpts.shape[0] - 1)] - base
    yaw = np.arctan2(tang[:, 1], tang[:, 0])
    egos_xy = base + rng.normal(0, 0.3, (S, 2))
    dyaw = rng.normal(0, 0.3, S)
    dyaw[:8] = np.linspace(-1.2, 1.2, 8)  # force the 4-sigma tails
    yaws = yaw + dyaw
    centers = jax.vmap(
        lambda e, y: costmap.corridor_geometry(cp, wpts, n, e, y)[0]
    )(jnp.asarray(egos_xy), jnp.asarray(yaws))
    c = np.asarray(centers)
    assert (c[:, 0] >= x_lo).all() and (c[:, 0] <= x_hi).all()
    assert (c[:, 1] >= y_lo).all() and (c[:, 1] <= y_hi).all()


def test_batched_costmap_matches_vmapped_single_builds(global_plan):
    """build_local_costmap_batched (one vmapped pre-stage + one batched
    propagation) equals build_local_costmap per scenario."""
    import jax

    cp = small_costmap_params(rows=16, cols=12)
    rng = np.random.default_rng(9)
    gm = jnp.asarray(rng.uniform(0, 100, (64, 64)))
    ggeom = gridmap.make_geom([100.0, -305.0], 2.0, 64, 64, dtype=jnp.float64)
    wpts = jnp.asarray(global_plan)
    n = jnp.asarray(wpts.shape[0])
    egos = jnp.asarray(
        np.array([100.0, -305.6, 4.0, 0.05])[None, :] + rng.normal(0, 0.3, (3, 4)))
    obs = (jnp.asarray([[108.0, -305.0]]), jnp.asarray([[3.63, 1.84]]),
           jnp.asarray([0.1]), jnp.asarray([1.0]))
    sig = jnp.asarray([0.05, 0.04, 0.02])

    got = costmap.build_local_costmap_batched(
        cp, gm, ggeom, wpts, n, egos, *obs, sigmas=sig)
    want = jax.vmap(lambda e: costmap.build_local_costmap(
        cp, gm, ggeom, wpts, n, e, *obs, sigmas=sig))(egos)
    for name in ("vehicle_map", "bounding_box_map", "uncertainty_map",
                 "corridor_mask"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=1e-12, atol=1e-10, err_msg=name)
    assert np.ptp(np.asarray(got.uncertainty_map)) > 1.0


def test_cell_sigma_rho_anisotropic_rotates_diag():
    """Advisor r3: anisotropic (sigma_x != sigma_y) translational
    covariance must rotate into the map frame.  Check the implied 2x2
    covariance against the direct R(-yaw) diag R(yaw) + lever form, and
    that the isotropic path is bit-identical to the historical formula."""
    cp = small_costmap_params()
    xs = jnp.linspace(-2.0, 3.0, 7)
    ys = jnp.linspace(-1.5, 1.5, 5)

    for yaw in (0.0, 0.7, -2.2, np.pi / 2):
        sx_c, sy_c, rho = costmap.cell_sigma_rho(
            cp, xs, ys, jnp.asarray(yaw), sigmas=(0.3, 0.1, 0.05))
        s, c = np.sin(yaw), np.cos(yaw)
        R = np.array([[c, -s], [s, c]])
        cov_g = np.diag([0.3**2, 0.1**2])
        cov_m_t = R.T @ cov_g @ R
        for i, Cx in enumerate(np.asarray(xs)):
            for j, Cy in enumerate(np.asarray(ys)):
                g_m = np.array([-Cy, Cx])
                cov_m = cov_m_t + 0.05**2 * np.outer(g_m, g_m)
                np.testing.assert_allclose(
                    float(sx_c[i, j]) ** 2, cov_m[0, 0], rtol=1e-5)
                np.testing.assert_allclose(
                    float(sy_c[i, j]) ** 2, cov_m[1, 1], rtol=1e-5)
                np.testing.assert_allclose(
                    float(rho[i, j]) * float(sx_c[i, j]) * float(sy_c[i, j]),
                    cov_m[0, 1], rtol=1e-5, atol=1e-9)

    # isotropic: bit-identical to the historical (unrotated) formula
    sx_c, sy_c, rho = costmap.cell_sigma_rho(
        cp, xs, ys, jnp.asarray(0.9), sigmas=(0.16, 0.16, 0.017))
    u = (-ys[None, :]) ** 2 + 0.0 * xs[:, None]
    v = (xs[:, None]) ** 2 + 0.0 * ys[None, :]
    t = (-ys[None, :] + 0.0 * xs[:, None]) * (xs[:, None] + 0.0 * ys[None, :])
    sx_ref = jnp.sqrt(0.16**2 + 0.017**2 * u)
    sy_ref = jnp.sqrt(0.16**2 + 0.017**2 * v)
    np.testing.assert_array_equal(np.asarray(sx_c), np.asarray(sx_ref))
    np.testing.assert_array_equal(np.asarray(sy_c), np.asarray(sy_ref))
    np.testing.assert_array_equal(
        np.asarray(rho), np.asarray(0.017**2 * t / (sx_ref * sy_ref)))
