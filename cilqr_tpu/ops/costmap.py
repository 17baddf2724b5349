"""Local uncertainty-costmap engine — the JAX equivalent of the
``map_engine`` node (``CILQR/src/map_engine/src/local_costmap.cpp`` +
``arbitrary_transformation.cu`` / ``ARBIT.cuh``).

Pipeline per planning tick (odomCallback, local_costmap.cpp:172-310):
  1. corridor-derived map geometry        (getVehicleMapScale, :712-805)
  2. obstacle OBB rasterization           (bondingBoxHandle, :860-922)
  3. prior-map resampling by rotated gather (:242-264)
  4. uncertainty propagation              (thrust_propagateUncertainty)
  5. planner map assembly                 (:296-306)

Design notes:
* The reference resizes the grid every tick from the corridor bbox; XLA needs
  static shapes, so the grid is a fixed (rows, cols) patch whose *center*
  follows the corridor bbox while the extent stays rows*res x cols*res.
* The data-dependent ``EllipseIterator`` footprint becomes a fixed
  (2R+1)^2 window + analytic inside-ellipse mask.  The iterator's per-cell
  inside test ((T d)^2 / semiAxes^2 <= 1, EllipseIterator.cpp:84-90) is
  algebraically identical to  d^T cov^-1 d <= chi^2,  so the 2x2
  eigendecomposition of the CUDA path (arbitrary_transformation.cu:60-83)
  is not needed at all — pure elementwise math.
* The hot accumulation loop (OpenMP x8 on host in the reference,
  arbitrary_transformation.cu:102-151) is a scan over window offsets with
  shifted adds on XLA, and a tiled Triton kernel on the GPU
  (``ops/uncertainty_pallas.py``); ``propagate_uncertainty_batched`` picks
  the route from the backend and the input.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cilqr_tpu.ops import gridmap
from cilqr_tpu.utils.params import CostmapParams


class LocalCostmap(NamedTuple):
    """Multi-layer vehicle-frame costmap (layers of local_costmap.cpp:125-132).

    The reference declares six layers; ``lidar_grid_map`` is dead upstream
    (every write commented out, local_costmap.cpp:221-225,254-256) and has no
    analog here.  ``semantic_lidar_map`` (the KF-tracked perception box,
    :328-394) and ``ellipse_map`` (declared "for visual uncertainty ellipse",
    :130, writes commented at :622) are populated on demand and ``None``
    otherwise so the batched hot path carries no dead weight.
    """

    vehicle_map: jax.Array       # (rows, cols) prior + obstacle occupancy
    bounding_box_map: jax.Array  # (rows, cols) rasterized obstacle OBBs
    uncertainty_map: jax.Array   # (rows, cols) propagated occupancy
    corridor_mask: jax.Array     # (rows, cols) 1 inside the dynamic corridor
    geom: gridmap.GridGeom       # vehicle-frame geometry (center, res, length)
    origin_xy: jax.Array         # (2,) ego global position (map origin)
    origin_yaw: jax.Array        # () ego global yaw
    semantic_lidar_map: Optional[jax.Array] = None  # (rows, cols) tracked bbox
    ellipse_map: Optional[jax.Array] = None         # (rows, cols) ego 95% ellipse


def _path_headings(waypoints: jax.Array, idx: jax.Array, n_valid,
                   fallback_yaw) -> jax.Array:
    """Path-tangent headings at waypoint indices ``idx`` (the reference
    reads waypoint quaternions; we derive the equivalent from tangents).

    Degenerate tail (repeated last waypoint): forward-fill the last valid
    heading (the reference stops its loop before the final waypoint and
    never evaluates a zero tangent); ``fallback_yaw`` only as a last
    resort when no index has a valid tangent at all.  Shared by
    ``corridor_geometry`` and ``corridor_center_bounds`` so the sweep poses
    can never desynchronize from the geometry being bounded."""
    wp = waypoints[idx]
    nxt = waypoints[jnp.minimum(idx + 1, n_valid - 1)]
    tangent = nxt - wp
    yaw_w = jnp.arctan2(tangent[:, 1], tangent[:, 0])
    ok = jnp.sum(tangent * tangent, axis=-1) > 1e-12
    L = yaw_w.shape[0]
    last_valid = jax.lax.cummax(jnp.where(ok, jnp.arange(L), -1))
    yaw_filled = yaw_w[jnp.maximum(last_valid, 0)]
    return jnp.where(last_valid >= 0, yaw_filled, fallback_yaw)


def corridor_geometry(
    cp: CostmapParams,
    waypoints: jax.Array,
    n_valid: jax.Array,
    ego_xy: jax.Array,
    ego_yaw: jax.Array,
):
    """Vehicle-map center from the lane-corridor bounding box.

    Mirrors ``getVehicleMapScale`` (local_costmap.cpp:712-805): take
    ``look_ahead_waypoints`` waypoints from the nearest one, offset the lane
    center 8 m left / 4 m right along heading - pi/2, transform to the
    vehicle frame, and bound.  Returns (center (2,), (x_len, y_len),
    (x_min, x_max, y_min, y_max)) — the dynamic extent is reported for
    parity/telemetry and the corridor-mask layer, but the grid extent stays
    static (see module docstring).  The -5 m x shift applied when the
    reference sets geometry (local_costmap.cpp:213) is included.
    """
    # nearest waypoint (searchTargetIndex, :661-710 — warm start replaced by
    # a full masked argmin: same result, no state)
    from cilqr_tpu.models.reference_path import closest_point_index

    start = closest_point_index(waypoints, n_valid, ego_xy)

    idx = jnp.minimum(start + jnp.arange(cp.look_ahead_waypoints), n_valid - 1)
    wp = waypoints[idx]  # (L, 2)
    yaw_w = _path_headings(waypoints, idx, n_valid, ego_yaw)

    heading = yaw_w - jnp.pi / 2.0
    heading = jnp.where(heading < 0, heading + 2 * jnp.pi, heading)
    ch, sh = jnp.cos(heading), jnp.sin(heading)
    left = wp - cp.corridor_left * jnp.stack([ch, sh], axis=-1)
    right = wp + cp.corridor_right * jnp.stack([ch, sh], axis=-1)
    corridor = jnp.concatenate([left, right], axis=0)  # (2L, 2)

    # global -> vehicle frame
    cy, sy = jnp.cos(ego_yaw), jnp.sin(ego_yaw)
    dxy = corridor - ego_xy
    local = jnp.stack(
        [cy * dxy[:, 0] + sy * dxy[:, 1], -sy * dxy[:, 0] + cy * dxy[:, 1]],
        axis=-1,
    )
    x_min, x_max = jnp.min(local[:, 0]), jnp.max(local[:, 0])
    y_min, y_max = jnp.min(local[:, 1]), jnp.max(local[:, 1])
    x_len = x_max - x_min
    y_len = y_max - y_min
    center = jnp.stack([x_len / 2.0 - 5.0, (y_max + y_min) / 2.0])
    return center, (x_len, y_len), (x_min, x_max, y_min, y_max)


def corridor_center_bounds(
    cp: CostmapParams,
    waypoints,
    n_valid: int,
    lateral_offsets=(-3.0, 0.0, 3.0),
    max_yaw_dev: float = 1.2,
    n_yaw: int = 9,
    x_margin: float = 5.0,
    y_margin: float = 5.0,
):
    """Concrete bounds on the corridor-derived map center over a route.

    Evaluates ``corridor_geometry`` for ego poses swept along the global
    plan (each valid waypoint, at the path-tangent yaw) x a grid of lateral
    and yaw perturbations (initial-scatter + closed-loop tracking error),
    then pads with margins.  Feed the result to
    ``make_band_plan_bounds`` so the full-stack batched
    propagation's band radii cover every per-scenario vehicle-frame
    geometry the run can produce.  Must run OUTSIDE jit (concrete plan).

    ``max_yaw_dev`` must bound the worst |ego_yaw - path_yaw| the run can
    produce (default covers a 4-sigma tail of a 0.3 rad yaw scatter).  The
    center is a ROTATION of global offsets by -ego_yaw, so its extrema
    over the yaw range are interior, not at the endpoints — the sweep
    samples ``n_yaw`` points across the whole interval.

    Returns ((x_lo, x_hi), (y_lo, y_hi)) Python floats.
    """
    import numpy as _np

    nv = int(n_valid)
    if nv < 1:
        raise ValueError("corridor_center_bounds needs at least one waypoint")
    wpj = jnp.asarray(waypoints)
    nj = jnp.asarray(n_valid)
    wp = _np.asarray(waypoints, _np.float64)[:nv]
    yaw = _np.asarray(
        _path_headings(wpj, jnp.arange(nv), nj, jnp.asarray(0.0, wpj.dtype)),
        _np.float64,
    )

    def center_of(ego_xy, ego_yaw):
        c, _, _ = corridor_geometry(cp, wpj, nj, ego_xy, ego_yaw)
        return c

    centers = []
    for lat in lateral_offsets:
        # lateral = along heading - pi/2 (the corridor's own convention)
        exs = wp[:, 0] + lat * _np.cos(yaw - _np.pi / 2.0)
        eys = wp[:, 1] + lat * _np.sin(yaw - _np.pi / 2.0)
        for dy in _np.linspace(-max_yaw_dev, max_yaw_dev, n_yaw):
            cs = jax.vmap(center_of)(
                jnp.asarray(_np.stack([exs, eys], -1), wpj.dtype),
                jnp.asarray(yaw + dy, wpj.dtype),
            )
            centers.append(_np.asarray(cs))
    cat = _np.concatenate(centers, axis=0)
    return (
        (float(cat[:, 0].min() - x_margin), float(cat[:, 0].max() + x_margin)),
        (float(cat[:, 1].min() - y_margin), float(cat[:, 1].max() + y_margin)),
    )


def rasterize_obstacles(
    cp: CostmapParams,
    geom: gridmap.GridGeom,
    rows: int,
    cols: int,
    obs_xy: jax.Array,
    obs_size: jax.Array,
    obs_yaw: jax.Array,
    obs_mask: jax.Array,
    ego_xy: jax.Array,
    ego_yaw: jax.Array,
) -> jax.Array:
    """Bounding-box layer: inflated rotated rectangles of nearby obstacles.

    Mirrors ``bondingBoxHandle`` (local_costmap.cpp:860-922): +0.2 m
    inflation, 100 m range gate, corners rotated by obstacle yaw then
    transformed to the vehicle frame, filled at value 100 via the polygon
    mask (replacing PolygonIterator).
    """
    dtype = geom.center.dtype
    M = obs_xy.shape[0]
    dist = jnp.sqrt(jnp.sum((obs_xy - ego_xy) ** 2, axis=-1))
    active = obs_mask.astype(bool) & (dist <= cp.obstacle_raster_radius)

    half = 0.5 * (obs_size + cp.bbox_inflation)  # (M, 2)
    corners_l = jnp.stack(
        [
            jnp.stack([half[:, 0], half[:, 1]], axis=-1),
            jnp.stack([half[:, 0], -half[:, 1]], axis=-1),
            jnp.stack([-half[:, 0], -half[:, 1]], axis=-1),
            jnp.stack([-half[:, 0], half[:, 1]], axis=-1),
        ],
        axis=1,
    )  # (M, 4, 2)
    co, so = jnp.cos(obs_yaw)[:, None], jnp.sin(obs_yaw)[:, None]
    gx = co * corners_l[..., 0] - so * corners_l[..., 1] + obs_xy[:, 0:1]
    gy = so * corners_l[..., 0] + co * corners_l[..., 1] + obs_xy[:, 1:2]
    cy, sy = jnp.cos(ego_yaw), jnp.sin(ego_yaw)
    lx = cy * (gx - ego_xy[0]) + sy * (gy - ego_xy[1])
    ly = -sy * (gx - ego_xy[0]) + cy * (gy - ego_xy[1])
    verts = jnp.stack([lx, ly], axis=-1)  # (M, 4, 2)

    def one(vs, act):
        m = gridmap.rasterize_polygon(geom, rows, cols, vs)
        return jnp.where(act, m, jnp.zeros_like(m))

    masks = jax.vmap(one)(verts, active)  # (M, rows, cols)
    return 100.0 * jnp.max(masks, axis=0).astype(dtype)


def rasterize_tracked_bbox(
    geom: gridmap.GridGeom,
    rows: int,
    cols: int,
    box: jax.Array,
    valid: jax.Array,
) -> jax.Array:
    """``semantic_lidar_map`` layer: fill the KF-smoothed perception box.

    Mirrors the SubmapIterator fill of ``bboxCallback``
    (local_costmap.cpp:358-371): ``box`` is the tracker's [cx, cy, w, h] in
    cell units of the 100-cell-offset camera convention; the start index is
    (150 - cy - h/2, 50 + cx - w/2) and the extent (h, w).  Invalid
    measurements clear the layer (local_costmap.cpp:331-336).
    """
    cx, cy, w, h = box[0], box[1], box[2], box[3]
    start = jnp.stack(
        [150.0 - cy - 0.5 * h, 50.0 + cx - 0.5 * w]
    ).astype(jnp.int32)
    size = jnp.stack([h, w]).astype(jnp.int32)
    m = gridmap.submap_mask(rows, cols, start, size, dtype=geom.center.dtype)
    return jnp.where(valid, 100.0 * m, jnp.zeros_like(m))


def sample_prior(
    geom: gridmap.GridGeom,
    rows: int,
    cols: int,
    global_map: jax.Array,
    global_geom: gridmap.GridGeom,
    ego_xy: jax.Array,
    ego_yaw: jax.Array,
) -> jax.Array:
    """Prior-map layer: nearest-cell lookup of the global map at every
    vehicle-frame cell rotated into the global frame (local_costmap.cpp:242-253)."""
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    cx = xs[:, None]
    cyy = ys[None, :]
    cyaw, syaw = jnp.cos(ego_yaw), jnp.sin(ego_yaw)
    gx = cx * cyaw - cyy * syaw + ego_xy[0]
    gy = cx * syaw + cyy * cyaw + ego_xy[1]
    pos = jnp.stack([gx, gy], axis=-1)  # (rows, cols, 2)
    return gridmap.sample_nearest(global_map, global_geom, pos)


def cell_sigma_rho(
    cp: CostmapParams,
    xs: jax.Array,
    ys: jax.Array,
    ego_yaw: jax.Array,
    faithful: bool = False,
    sigmas=None,
):
    """Per-cell propagated covariance terms (sigma_x_i, sigma_y_i, rho).

    Mirrors ``uncertainty_error_functor`` (ARBIT.cuh:51-69): the pose
    uncertainty (sigma_x, sigma_y, sigma_theta) of the ego maps to a
    cell-dependent 2D position covariance growing with lever arm |cell|:
    for p = R(yaw) C + v the theta-Jacobian in the GLOBAL frame is
    g_g = (-s Cx - c Cy, c Cx - s Cy) and cov_g = diag(sigma_x^2,
    sigma_y^2) + sigma_theta^2 g_g g_g^T.

    FRAME CORRECTION (default path): the reference's grid_map grids are
    axis-aligned to the global frame, so applying cov_g to ITS cell offsets
    is self-consistent.  THIS framework's static corridor grid rotates
    with the vehicle (ARCHITECTURE §1 rule 3), and the propagation weights
    MAP-frame offsets — the covariance must live in the map frame:
    cov_m = R(-yaw) cov_g R(yaw), whose lever vector is R(-yaw) g_g =
    R'(0) C = (-Cy, Cx), yaw-independent.  The positional diag part is
    rotated too (advisor r3): R(-yaw) diag(sx^2, sy^2) R(yaw) in the
    delta form d = sx^2 - sy^2 (xx: sx^2 - d s^2, yy: sy^2 + d s^2,
    xy: -d s c), which is EXACT for anisotropic sigmas and bit-identical
    to the historical isotropic path when d == 0 (the launch defaults) —
    the terms reduce to sx^2, sy^2, +0.0 with no (c^2+s^2) rounding.
    Carrying the
    global-frame g into the rotated grid mis-rotates every smear ellipse
    by -yaw — invisible at yaw ~ 0 (all axis-aligned scenarios) and first
    caught by the rotated-gauntlet production sweep (docs/BASELINES.md),
    where it flipped the uncertainty-aware planner's collision column.

    ``faithful=True`` reproduces the reference formula bit-for-bit for
    parity studies — the global-frame lever (correct for ITS axis-aligned
    grid) AND its cross-term sign defect (ARBIT.cuh:62-63 flips the sign
    of the s*c*(Cx^2-Cy^2) contribution relative to g1*g2, making |rho|
    exceed 1 at some yaws; non-PSD "covariance" -> NaN ellipse in the
    C++).  Callers must then guard |rho| >= 1 cells (we fall back to the
    prior, matching the count==0 branch at local_costmap.cpp:489-496).
    """
    Cx = xs[:, None]
    Cy = ys[None, :]
    if faithful:
        s, c = jnp.sin(ego_yaw), jnp.cos(ego_yaw)
        g1 = -s * Cx - c * Cy
        g2 = c * Cx - s * Cy
        t = s * c * (Cx * Cx - Cy * Cy) + Cx * Cy * (s * s - c * c)
    else:
        # map-frame lever R(-yaw) g_g = (-Cy, Cx): yaw-free
        g1 = -Cy + 0.0 * Cx  # broadcast to (rows, cols)
        g2 = Cx + 0.0 * Cy
        t = g1 * g2
    u = g1 * g1
    v = g2 * g2
    if sigmas is None:
        s_x, s_y, s_t = cp.sigma_x, cp.sigma_y, cp.sigma_theta
    else:
        s_x, s_y, s_t = sigmas
    if faithful:
        dxx = dyy = dxy = 0.0  # reference form: unrotated diag
    else:
        # map-frame rotation of the translational diag (delta form; see
        # docstring) — zero contribution, bit-exactly, when s_x == s_y
        sin_y, cos_y = jnp.sin(ego_yaw), jnp.cos(ego_yaw)
        d = s_x**2 - s_y**2
        dxx = -d * sin_y * sin_y
        dyy = d * sin_y * sin_y
        dxy = -d * sin_y * cos_y
    sx = jnp.sqrt(s_x**2 + dxx + s_t**2 * u)
    sy = jnp.sqrt(s_y**2 + dyy + s_t**2 * v)
    rho = (dxy + s_t**2 * t) / (sx * sy)
    return sx, sy, rho


def required_window_radius(
    cp: CostmapParams, rows: int, cols: int, center=(None, None), sigmas=None
) -> int:
    """Smallest half-window (cells) covering the worst-case 95% ellipse.

    half_major = chi * sqrt(lambda_max(cov)) <= chi * sqrt(a + c) with
    a + c = sigma_x^2 + sigma_y^2 + sigma_theta^2 * |cell|^2, evaluated at
    the map corner (max lever arm).  ``center`` defaults to the configured
    (x_position - 5, y_position) map center; ``sigmas`` overrides the
    configured (sigma_x, sigma_y, sigma_theta) — pass the sampling *upper
    bound* for Monte-Carlo sweeps.
    """
    cx = center[0] if center[0] is not None else cp.x_position - 5.0
    cy = center[1] if center[1] is not None else cp.y_position
    s_x, s_y, s_t = sigmas if sigmas is not None else (cp.sigma_x, cp.sigma_y, cp.sigma_theta)
    res = cp.resolution
    corner = math.hypot(rows * res / 2 + abs(cx), cols * res / 2 + abs(cy))
    a_plus_c = s_x**2 + s_y**2 + s_t**2 * corner**2
    half_major = cp.chisquare_val * math.sqrt(a_plus_c)
    return max(1, math.ceil(half_major / res))


def propagate_uncertainty_reference(
    cp: CostmapParams,
    prior: jax.Array,
    geom: gridmap.GridGeom,
    ego_yaw: jax.Array,
    faithful_rho: bool = False,
    sigmas=None,
) -> jax.Array:
    """Pure-JAX (XLA) uncertainty propagation — the semantics oracle for the
    GPU kernel and the XLA route.

    For every cell i:  u_i = sum_j f_ij p_j / sum_j f_ij  over cells j inside
    the 95% ellipse of cov_i AND inside the map, with f the correlated 2D
    Gaussian pdf ``nomal2`` (ARBIT.cuh:103-107, accumulation
    arbitrary_transformation.cu:115-138).  The data-dependent
    EllipseIterator becomes a fixed (2R+1)^2 offset scan with the analytic
    inside test  d^T cov^-1 d <= chi^2.
    """
    rows, cols = prior.shape
    dtype = prior.dtype
    R = cp.window_radius
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    sx, sy, rho = cell_sigma_rho(cp, xs, ys, ego_yaw, faithful=faithful_rho, sigmas=sigmas)
    sx = sx.astype(dtype)
    sy = sy.astype(dtype)
    rho = rho.astype(dtype)

    # Non-PSD guard (reachable only with faithful_rho=True — see
    # cell_sigma_rho): such cells keep the prior.
    psd = jnp.abs(rho) < 1.0
    rho = jnp.where(psd, rho, 0.0)

    one_m_rho2 = 1.0 - rho * rho
    inv_det2 = 1.0 / (2.0 * one_m_rho2)
    # the Gaussian normalizer 1/(sqrt(1-rho^2) 2 pi sx sy) depends only on
    # the output cell and cancels exactly in num/den — omitted
    chi2 = cp.chisquare_val**2

    res = cp.resolution
    # neighbor j at index offset (di, dj) sits at position offset
    # (-di*res, -dj*res) (indices grow against position)
    prior_pad = jnp.pad(prior, R, mode="constant", constant_values=0.0)
    valid_pad = jnp.pad(jnp.ones_like(prior), R, mode="constant", constant_values=0.0)

    W = 2 * R + 1

    two_rho = rho + rho

    def body(k, acc):
        num, den = acc
        di = k // W - R
        dj = k % W - R
        dx = (-di * res).astype(dtype)
        dy = (-dj * res).astype(dtype)
        p_j = jax.lax.dynamic_slice(prior_pad, (di + R, dj + R), (rows, cols))
        v_j = jax.lax.dynamic_slice(valid_pad, (di + R, dj + R), (rows, cols))

        zx = dx / sx
        zy = dy / sy
        # q = zx^2 - 2 rho zx zy + zy^2, factored as the GPU kernel's form
        # (uncertainty_pallas._kernel) so the two paths stay close
        q = (zx - two_rho * zy) * zx + zy * zy
        # inside-ellipse test: d^T cov^-1 d = q / (1 - rho^2) <= chi^2
        inside = q <= chi2 * one_m_rho2
        f = jnp.exp(-q * inv_det2)
        w = jnp.where(inside & (v_j > 0), f, 0.0)
        return (num + w * p_j, den + w)

    num0 = jnp.zeros_like(prior)
    den0 = jnp.zeros_like(prior)
    num, den = jax.lax.fori_loop(0, W * W, body, (num0, den0))
    # the weighted average of occupancies in [0, 100] is in [0, 100]
    # mathematically; clamp the low-precision rounding overshoot
    return jnp.where(psd & (den > 0), jnp.clip(num / den, 0.0, 100.0), prior)


class BandPlan(NamedTuple):
    """Static row-band decomposition for batched propagation.

    bands: ((row0, band_rows, radius), ...) contiguous from row 0;
    sigma_hi: the (sigma_x, sigma_y, sigma_theta) upper bound the radii
    cover — consumers cross-check their own sampling bound against it
    (None when the plan is a plain full-map window);
    x_range / y_range: the map-frame center interval the radii cover
    (``make_band_plan`` returns degenerate (c, c) intervals for its fixed
    center; None only for hand-built full-window plans, whose single
    worst-case radius needs no center bookkeeping).  The caller must
    guarantee every per-scenario center stays inside the intervals —
    centers are traced at propagation time, so no runtime check is
    possible (see ``corridor_center_bounds``).
    disc_radii: per-band float disc radii (cells) for the exact disc cut
    (offsets with di^2 + dj^2 > r^2 carry w = 0); None = full square.
    """

    bands: tuple
    sigma_hi: tuple | None
    x_range: tuple | None = None
    y_range: tuple | None = None
    disc_radii: tuple | None = None


def check_band_plan(band_plan: BandPlan, rows: int) -> None:
    """Reject a plan whose bands are not contiguous or do not cover ``rows``."""
    covered = 0
    for (r0, br, _) in band_plan.bands:
        if r0 != covered:
            raise ValueError(
                f"band plan not contiguous at row {covered}: {band_plan.bands}")
        covered += br
    if covered != rows:
        raise ValueError(
            f"band plan covers {covered} rows but the prior has {rows} — "
            "stale plan for a different map shape")


def make_band_plan(cp: CostmapParams, rows: int, cols: int, center,
                   sigma_hi, max_bands=None) -> BandPlan:
    """Static row bands with per-band window radii for banded propagation.

    The fixed window sizes its (2R+1)^2 accumulation for the WORST cell of
    the map (``required_window_radius``'s corner bound), but the required
    95%-ellipse radius grows with the per-cell lever arm |cell| — near-ego
    rows need a fraction of the corner radius.  Splitting the rows into
    contiguous bands whose radius is that band's own worst-row bound cuts
    the accumulation work ~2-4x EXACTLY: a window that covers every cell's
    95% ellipse yields the same result (outside-ellipse offsets contribute
    w = 0).  Must be built OUTSIDE jit (concrete center).
    """
    cx, cy = float(center[0]), float(center[1])
    return make_band_plan_bounds(
        cp, rows, cols, (cx, cx), (cy, cy), sigma_hi, max_bands=max_bands
    )


def make_band_plan_bounds(cp: CostmapParams, rows: int, cols: int,
                          x_range, y_range, sigma_hi,
                          max_bands=None) -> BandPlan:
    """``make_band_plan`` for an INTERVAL of map-frame centers.

    The full-stack batched path gives every scenario its own vehicle-frame
    geometry (the corridor-derived center moves with the route,
    ``corridor_center_bounds``); band radii must cover the worst center the
    batch can produce.  Per row band the lever arm is maximized over
    center_x in ``x_range`` and center_y in ``y_range`` — still EXACT for
    every scenario whose center stays inside the intervals.

    ``max_bands`` defaults to 8-row bands, one row tile of the GPU kernel.
    """
    import numpy as _np

    res = cp.resolution
    x_lo, x_hi = float(x_range[0]), float(x_range[1])
    y_lo, y_hi = float(y_range[0]), float(y_range[1])
    if x_lo > x_hi or y_lo > y_hi:
        raise ValueError(f"empty center range {x_range} x {y_range}")
    # row i cell x = center_x + off_i; worst |x| is at an interval endpoint
    off = 0.5 * rows * res - 0.5 * res - res * _np.arange(rows)
    max_x = _np.maximum(_np.abs(x_lo + off), _np.abs(x_hi + off))
    # |y| is linear in center_y too: worst at an endpoint, + half extent
    max_y = max(abs(y_lo), abs(y_hi)) + 0.5 * cols * res - 0.5 * res
    lever = _np.hypot(max_x, max_y)
    s_x, s_y, s_t = sigma_hi
    need = _np.ceil(
        cp.chisquare_val
        * _np.sqrt(s_x * s_x + s_y * s_y + s_t * s_t * lever * lever)
        / res
    ).astype(int)
    need = _np.maximum(need, 1)
    # exact disc radius: |d| <= chi sqrt(lambda_max) with
    # lambda_max <= max(s_x, s_y)^2 + s_t^2 lever^2 (diag + rank-1 split)
    s_m = max(s_x, s_y)
    disc = cp.chisquare_val * _np.sqrt(s_m * s_m + s_t * s_t * lever * lever) / res

    n_b = min(int(max_bands) if max_bands else max(1, rows // 8), rows)
    bounds = _np.linspace(0, rows, n_b + 1).astype(int)
    bands = []
    radii = []
    for i in range(n_b):
        r0, r1 = int(bounds[i]), int(bounds[i + 1])
        if r1 > r0:
            bands.append((r0, r1 - r0, int(need[r0:r1].max())))
            radii.append(float(disc[r0:r1].max()))
    return BandPlan(
        tuple(bands), (float(s_x), float(s_y), float(s_t)),
        (x_lo, x_hi), (y_lo, y_hi), tuple(radii),
    )


def kernel_route(dtype) -> bool:
    """True when propagation takes the GPU kernel: a GPU backend and a
    float32 prior (float64 parity runs stay on XLA)."""
    return jax.default_backend() == "gpu" and dtype == jnp.float32


def propagate_uncertainty_batched(
    cp: CostmapParams,
    prior: jax.Array,
    geom: gridmap.GridGeom,
    ego_yaw: jax.Array,
    sigmas=None,
    band_plan: Optional[BandPlan] = None,
) -> jax.Array:
    """Batched propagation, (B, rows, cols): ``prior`` shared (rows, cols) or
    per-scenario (B, rows, cols); any of (geom, ego_yaw, sigmas (B, 3))
    may carry the scenario axis.

    The GPU kernel (``ops.uncertainty_pallas``) walks the band plan's
    per-band windows; the XLA route vmaps ``propagate_uncertainty_reference``
    over the full ``cp.window_radius`` window.  Both are exact as long as
    the plan covers every cell's 95% ellipse."""
    if kernel_route(prior.dtype):
        from cilqr_tpu.ops import uncertainty_pallas

        return uncertainty_pallas.propagate_batched(
            cp, prior, geom, ego_yaw, sigmas, band_plan)
    pr_ax = 0 if prior.ndim == 3 else None
    geom_ax = 0 if geom.center.ndim == 2 else None
    yaw_ax = 0 if jnp.ndim(ego_yaw) == 1 else None
    sig_ax = 0 if sigmas is not None else None

    def one(pr, g, y, s):
        sig = None if s is None else (s[0], s[1], s[2])
        return propagate_uncertainty_reference(cp, pr, g, y, sigmas=sig)

    return jax.vmap(one, in_axes=(pr_ax, geom_ax, yaw_ax, sig_ax))(
        prior, geom, ego_yaw, sigmas)


def _costmap_pre(
    cp: CostmapParams,
    global_map: jax.Array,
    global_geom: gridmap.GridGeom,
    waypoints: jax.Array,
    n_wpts: jax.Array,
    ego_state: jax.Array,
    obs_xy: jax.Array,
    obs_size: jax.Array,
    obs_yaw: jax.Array,
    obs_mask: jax.Array,
):
    """Everything before the uncertainty propagation: corridor geometry,
    corridor mask, obstacle rasterization, prior sampling + bbox override.

    """
    rows, cols = cp.rows, cp.cols
    ego_xy = ego_state[:2]
    ego_yaw = ego_state[3]

    center, _, bounds = corridor_geometry(cp, waypoints, n_wpts, ego_xy, ego_yaw)
    geom = gridmap.GridGeom(
        center.astype(global_map.dtype),
        jnp.asarray(cp.resolution, global_map.dtype),
        jnp.asarray([rows * cp.resolution, cols * cp.resolution], global_map.dtype),
    )
    # cells inside the reference's *dynamic* corridor bbox (the part of the
    # static grid the resizing reference map would actually have covered)
    xs, ys = gridmap.cell_positions(geom, rows, cols)
    x_min, x_max, y_min, y_max = bounds
    corridor = (
        (xs[:, None] >= x_min) & (xs[:, None] <= x_max)
        & (ys[None, :] >= y_min) & (ys[None, :] <= y_max)
    ).astype(global_map.dtype)

    bbox = rasterize_obstacles(
        cp, geom, rows, cols, obs_xy, obs_size, obs_yaw, obs_mask, ego_xy, ego_yaw
    )
    prior = sample_prior(geom, rows, cols, global_map, global_geom, ego_xy, ego_yaw)
    # bbox overrides prior where > 90 (local_costmap.cpp:260-263)
    vehicle_map = jnp.where(bbox > 90.0, bbox, prior)
    return vehicle_map, bbox, corridor, geom


def build_local_costmap(
    cp: CostmapParams,
    global_map: jax.Array,
    global_geom: gridmap.GridGeom,
    waypoints: jax.Array,
    n_wpts: jax.Array,
    ego_state: jax.Array,
    obs_xy: jax.Array,
    obs_size: jax.Array,
    obs_yaw: jax.Array,
    obs_mask: jax.Array,
    tracked_box: Optional[jax.Array] = None,
    tracked_valid: Optional[jax.Array] = None,
    with_ellipse_layer: bool = False,
    sigmas: Optional[jax.Array] = None,
) -> LocalCostmap:
    """Full costmap tick (odomCallback, local_costmap.cpp:172-310).

    ``tracked_box``/``tracked_valid``: the KF-smoothed perception box from
    ``models.tracker.step`` (fed by ``sim.perception.bbox_measurement``).
    When given, it is rasterized into the ``semantic_lidar_map`` layer
    (bboxCallback, local_costmap.cpp:358-371) and overrides the vehicle map
    where > 90 — the override the reference declares but leaves commented
    out (:257-259); it is enabled here whenever the perception channel is
    active, since a tracked box that never reaches the planner-consumed
    layers would be dead weight.  ``with_ellipse_layer`` additionally fills
    the viz-only ``ellipse_map`` with the ego-pose 95% confidence ellipse
    footprint (the live realization of the layer declared at :130).
    ``sigmas`` (3,) overrides the configured propagation sigmas as a traced
    value (one compiled program serves a whole sigma sweep; size
    ``cp.window_radius`` for the largest sigma via
    ``required_window_radius``).
    """
    ego_xy = ego_state[:2]
    ego_yaw = ego_state[3]
    vehicle_map, bbox, corridor, geom = _costmap_pre(
        cp, global_map, global_geom, waypoints, n_wpts, ego_state,
        obs_xy, obs_size, obs_yaw, obs_mask,
    )

    semantic = None
    if tracked_box is not None:
        semantic = rasterize_tracked_bbox(
            geom, cp.rows, cp.cols, tracked_box, tracked_valid
        )
        vehicle_map = jnp.where(semantic > 90.0, semantic, vehicle_map)

    ellipse = None
    if with_ellipse_layer:
        s_x = jnp.asarray(cp.sigma_x, vehicle_map.dtype)
        s_y = jnp.asarray(cp.sigma_y, vehicle_map.dtype)
        # ego sits at vehicle-frame (0, 0): zero lever arm, cov = diag(sx², sy²)
        cov = jnp.diag(jnp.stack([s_x * s_x, s_y * s_y]))
        hm, hmin, ang = gridmap.confidence_ellipse(cov, cp.chisquare_val)
        ellipse = 100.0 * gridmap.ellipse_mask(
            geom, cp.rows, cp.cols, jnp.zeros(2, vehicle_map.dtype),
            jnp.stack([jnp.maximum(hm, cp.resolution), jnp.maximum(hmin, cp.resolution)]),
            ang,
        ).astype(vehicle_map.dtype)

    if kernel_route(vehicle_map.dtype):
        one = lambda a: jnp.asarray(a)[None]
        unc = propagate_uncertainty_batched(
            cp, vehicle_map, jax.tree.map(one, geom), one(ego_yaw),
            None if sigmas is None else one(jnp.stack(list(sigmas))),
        )[0]
    else:
        unc = propagate_uncertainty_reference(
            cp, vehicle_map, geom, ego_yaw, sigmas=sigmas)

    return LocalCostmap(vehicle_map, bbox, unc, corridor, geom, ego_xy, ego_yaw,
                        semantic_lidar_map=semantic, ellipse_map=ellipse)


def build_local_costmap_batched(
    cp: CostmapParams,
    global_map: jax.Array,
    global_geom: gridmap.GridGeom,
    waypoints: jax.Array,
    n_wpts: jax.Array,
    ego_states: jax.Array,
    obs_xy: jax.Array,
    obs_size: jax.Array,
    obs_yaw: jax.Array,
    obs_mask: jax.Array,
    band_plan=None,
    tracked_boxes: Optional[jax.Array] = None,
    tracked_valid: Optional[jax.Array] = None,
    sigmas: Optional[jax.Array] = None,
) -> LocalCostmap:
    """Per-scenario costmap ticks for a (B, 4) ego batch, one shared world.

    ``sigmas`` (B, 3) or (3,) overrides the configured propagation sigmas as
    a TRACED value (broadcast to every scenario when 1-D); the static
    ``band_plan`` / ``cp.window_radius`` must be sized for the largest
    sigma the caller will feed.

    ``tracked_boxes`` (B, 4) / ``tracked_valid`` (B,): per-scenario
    KF-smoothed perception boxes — rasterized into a batched
    ``semantic_lidar_map`` layer and overriding the vehicle map exactly as
    in the single-scenario tick (see ``build_local_costmap``).

    The pre-propagation stage (corridor geometry, rasterization, prior
    resample) is vmapped XLA; the propagation is
    ``propagate_uncertainty_batched`` with PER-SCENARIO priors, frames and
    yaws.  ``band_plan`` (``make_band_plan_bounds``, built for the
    configured sigmas and every vehicle-frame center the route can
    produce) sets the GPU kernel's per-band windows.  Returns a
    LocalCostmap whose leaves carry a leading B axis.
    """
    pre = jax.vmap(
        lambda e: _costmap_pre(
            cp, global_map, global_geom, waypoints, n_wpts, e,
            obs_xy, obs_size, obs_yaw, obs_mask,
        )
    )
    vehicle_map, bbox, corridor, geom = pre(ego_states)
    yaws = ego_states[:, 3]

    semantic = None
    if tracked_boxes is not None:
        semantic = jax.vmap(
            lambda g, bx, v: rasterize_tracked_bbox(g, cp.rows, cp.cols, bx, v)
        )(geom, tracked_boxes, tracked_valid)
        vehicle_map = jnp.where(semantic > 90.0, semantic, vehicle_map)

    if band_plan is not None and band_plan.sigma_hi is not None and sigmas is None:
        # a cached plan built for smaller sigmas would silently truncate 95%
        # ellipses (same guard as monte_carlo.monte_carlo applies for its
        # sampled-sigma plans).  With traced ``sigmas`` the values are
        # unknowable at trace time — the caller owns the bound.
        sh = band_plan.sigma_hi
        if cp.sigma_x > sh[0] or cp.sigma_y > sh[1] or cp.sigma_theta > sh[2]:
            raise ValueError(
                f"band plan sized for sigma_hi={sh} but the costmap "
                f"uses ({cp.sigma_x}, {cp.sigma_y}, {cp.sigma_theta})"
                " — rebuild it with make_band_plan_bounds"
            )
    sig_b = None
    if sigmas is not None:
        sig_b = jnp.broadcast_to(jnp.asarray(sigmas), (ego_states.shape[0], 3))
    unc = propagate_uncertainty_batched(
        cp, vehicle_map, geom, yaws, sig_b, band_plan)

    return LocalCostmap(
        vehicle_map, bbox, unc, corridor, geom, ego_states[:, :2], yaws,
        semantic_lidar_map=semantic,
    )
