"""Reference-path layer: global-plan windowing + polynomial local plan.

Reference semantics: ``CILQR/src/ilqr/include/ilqr/LocalPlanner.cpp`` and the
densified closest-point lookup at ``Constraints.cpp:24-59``.

Design notes
------------
* The global plan is a fixed-size padded array ``(P, 2)`` with a valid count;
  the reference used dynamic Eigen blocks (LocalPlanner.cpp:47-60).
* The degree-5 polynomial is fitted in a *centered + scaled* basis
  ``t = (x - x_mid) / x_scale``.  The reference fits raw global-frame powers
  (LocalPlanner.cpp:101-117) which is numerically hopeless in f32 at
  |x| ~ 100 m (x^5 ~ 1e10); centering keeps the Vandermonde condition number
  ~1e2 so the fit is exact to f32 while producing the *same evaluated
  polynomial* to within least-squares conditioning.  The fitted y-values —
  never the raw coefficients — are what enter the solver, so parity is
  preserved at the trajectory level (verified against the float64 oracle).
* ``find_closest_point`` becomes a dense (horizon, n_samples) distance argmin
  — one fused pass instead of an O(N*200) scalar scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cilqr_tpu.utils.params import SolverParams


class LocalPlan(NamedTuple):
    """Fitted local reference plan (all fields fixed-shape, jit-friendly)."""

    coeffs: jax.Array   # (poly_order+1,) in the scaled basis
    x_mid: jax.Array    # () basis center
    x_scale: jax.Array  # () basis scale (>= tiny)
    x_wpts: jax.Array   # (num_of_local_wpts,) window x (global frame)
    y_fit: jax.Array    # (num_of_local_wpts,) polynomial evaluated at x_wpts
    # densified sample table used by find_closest_point (Constraints.cpp:28-42)
    sample_x: jax.Array  # (n_samples,)
    sample_y: jax.Array  # (n_samples,)
    # local-frame sample table for the tournament argmin (see
    # find_closest_points): the query-frame transform of (sample_x,
    # sample_y) plus the per-sample squared norm.  Computed in
    # _local_channels, whose op order the GPU kernel (ops/lm_pallas)
    # mirrors when it regenerates the table.
    sample_xl: jax.Array  # (n_samples,)
    sample_yl: jax.Array  # (n_samples,)
    sample_r: jax.Array   # (n_samples,) sample_xl^2 + sample_yl^2
    # sample-table generator parameters [x0r, dr, ox, oy, cph, sph, qx, qy]:
    # the table is sx = ox + cph*sxr - sph*syr, sy = oy + sph*sxr + cph*syr
    # with sxr_s = x0r + dr*s, syr_s = poly(sxr_s); (qx, qy, cph, sph) is
    # the query frame of _local_channels.  Global-frame fits use the
    # identity rotation (ox=oy=sph=0, cph=1) with the window start as the
    # query origin.  Lets the GPU kernel (ops/lm_pallas) regenerate the
    # table from these parameters instead of reading the (B, n_samples, 3)
    # field from device memory.
    samp_frame: jax.Array  # (8,)


def closest_point_index(plan_xy: jax.Array, n_valid: jax.Array, point: jax.Array) -> jax.Array:
    """Index of the nearest global-plan point (LocalPlanner.cpp:25-41).

    Args:
      plan_xy: (P, 2) padded global plan.
      n_valid: () number of real points; padding is masked out.
      point:   (2,) or (4,) query (only [x, y] used).
    """
    d = jnp.sum((plan_xy - point[:2]) ** 2, axis=-1)
    idx = jnp.arange(plan_xy.shape[0])
    d = jnp.where(idx < n_valid, d, jnp.inf)
    return jnp.argmin(d)


def polyfit_scaled(
    x: jax.Array, y: jax.Array, order: int, weights: jax.Array | None = None
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Least-squares polynomial fit in a centered/scaled basis.

    Solves the same least-squares problem as the reference's
    colPivHouseholderQr on a raw Vandermonde (LocalPlanner.cpp:101-117), but
    on the well-conditioned basis t = (x - mid)/scale.
    Returns (coeffs ascending in t, mid, scale).

    ``weights`` (optional, per-row >= 0) turns the solve into weighted least
    squares — used by the exact end-of-plan window shrink, where padded
    repeat rows get weight 0.  A tiny ridge keeps the (order+1)^2 system
    solvable when fewer than order+1 rows carry weight (the reference's
    rank-deficient QR returns a least-norm solution there;
    LocalPlanner.cpp:113-116).
    """
    x_mid = 0.5 * (jnp.max(x) + jnp.min(x))
    x_scale = jnp.maximum(0.5 * (jnp.max(x) - jnp.min(x)), 1e-6)
    t = (x - x_mid) / x_scale
    # Normal equations on the scaled basis are fine (cond(V) ~ 1e1-1e2 for
    # t in [-1, 1]); the y offset is removed first so coefficient magnitudes
    # stay O(path curvature) rather than O(|y|~300 m).  The tiny (order+1)^2
    # SPD solve is an unrolled Cholesky (_chol_solve): elementwise under
    # vmap, with no batched LU.
    #
    # The Gram matrix of a Vandermonde is a HANKEL of power sums:
    # G[i, j] = sum_k w_k t_k^(i+j) — only 2*order+1 distinct entries.
    # Computing those as explicit reductions (repeated-multiply powers, no
    # pow) replaces batched (order+1, W) HIGHEST-precision matmuls of tiny
    # operands, and `t ** arange` would lower through the generic pow.
    tp = [jnp.ones_like(t)]  # t^0 .. t^(2*order), exact repeated multiply
    for _ in range(2 * order):
        tp.append(tp[-1] * t)
    if weights is not None:
        wsum = jnp.maximum(jnp.sum(weights), 1.0)
        y_mid = jnp.sum(weights * y) / wsum
        wr = weights
        ridge = 1e-9
    else:
        y_mid = jnp.mean(y)
        wr = None
        ridge = 0.0
    y0 = y - y_mid
    rsum = (lambda a: jnp.sum(a)) if wr is None else (lambda a: jnp.sum(wr * a))
    s = [rsum(tpm) for tpm in tp]  # power sums s_m = sum_k w_k t_k^m
    G = jnp.stack(
        [
            jnp.stack(
                [s[i + j] + (ridge if i == j else 0.0) for j in range(order + 1)]
            )
            for i in range(order + 1)
        ]
    )
    b = jnp.stack([rsum(y0 * tp[i]) for i in range(order + 1)])
    coeffs = _chol_solve(G, b)
    coeffs = coeffs.at[0].add(y_mid)
    return coeffs, x_mid, x_scale


def _chol_solve(G: jax.Array, b: jax.Array) -> jax.Array:
    """Solve SPD G x = b by fully-unrolled Cholesky (static small order).

    Pure elementwise ops — batches under vmap with no LAPACK-style
    loop-carried lowering.
    """
    m = G.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L z = b
    z = [None] * m
    for i in range(m):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    # back substitution L^T x = z
    x = [None] * m
    for i in reversed(range(m)):
        s = z[i]
        for k in range(i + 1, m):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def polyval_scaled(coeffs: jax.Array, x_mid: jax.Array, x_scale: jax.Array, x: jax.Array) -> jax.Array:
    """Evaluate the scaled-basis polynomial at raw x (Horner)."""
    t = (x - x_mid) / x_scale
    r = jnp.zeros_like(t)
    for c in coeffs[::-1]:
        r = r * t + c
    return r


def polyval_scaled_inv(coeffs: jax.Array, x_mid: jax.Array, inv_scale: jax.Array, x: jax.Array) -> jax.Array:
    """Horner with a precomputed reciprocal scale — used for the densified
    sample table so the GPU kernel's per-step 3-candidate refine
    (ops/lm_pallas) multiplies instead of dividing; the kernel mirrors this
    op order."""
    t = (x - x_mid) * inv_scale
    r = jnp.zeros_like(t)
    for c in coeffs[::-1]:
        r = r * t + c
    return r


def _local_channels(sx, sy, qx, qy, cph, sph):
    """Query-frame sample channels for the expanded-form distance tournament.

    ``d(p, s) = |p_l|^2 + r_s - 2 (x_l*sxl + y_l*syl)`` with both points
    transformed into a window-local frame keeps the f32 rounding of the
    expanded form ~1e-4 m^2 (vs ~0.04 m^2 in raw CARLA-scale global
    coordinates, where it would rival the adjacent-sample distance gap).
    The expression order here is mirrored op-for-op by the GPU kernel's
    table regeneration (ops/lm_pallas) so both paths pick the same
    winners up to compiler contraction of multiply-adds.
    """
    dx0 = sx - qx
    dy0 = sy - qy
    sxl = cph * dx0 + sph * dy0
    syl = cph * dy0 - sph * dx0
    r = sxl * sxl + syl * syl
    return sxl, syl, r


def get_local_plan(p: SolverParams, plan_xy: jax.Array, n_valid: jax.Array, ego_state: jax.Array) -> LocalPlan:
    """Window the global plan at the ego pose and fit the local polynomial.

    Mirrors ``LocalPlanner::get_local_plan`` / ``get_local_plan_coeffs``
    (LocalPlanner.cpp:47-96).  The reference shrinks the window near the end
    of the plan (LocalPlanner.cpp:51-58); with static shapes we clamp indices
    so trailing points repeat — identical while >= num_of_local_wpts points
    remain, and a documented, benign divergence in the final metres.
    Also pre-densifies the closest-point sample table (Constraints.cpp:28-42)
    once per solve instead of once per (iteration x timestep).
    """
    start = closest_point_index(plan_xy, n_valid, ego_state)
    # Window fetch: the desired rows are min(start+i, n_valid-1).  Because
    # pad_global_plan repeats the final waypoint, row min(start+i, P+W-1) of
    # a W-row-extended plan equals the desired row for every start <= n-1.
    # So precompute the (P, W*2) sliding-window table ONCE (unbatched under
    # vmap — plan_xy carries no batch dim) and fetch each scenario's whole
    # window with a single one-hot row-select matmul.  Versus one-hotting
    # every window row over P (a (B, W, P) one-hot ~ 170 MB at B=4096,
    # P=512), the one-hot here is (B, P) — 20x smaller — and the fetch is
    # one (B, P) @ (P, 2W) contraction.
    P, W = plan_xy.shape[0], p.num_of_local_wpts
    # exact end-of-plan shrink (LocalPlanner.cpp:51-58): the reference fits
    # only the remaining points when < W are left; with static shapes the
    # repeated tail rows get weight 0 instead of over-weighting the final
    # waypoint.  Off by default: the repeat-last clamp is the documented
    # benign divergence and saves the weighted-solve branch.
    fit_w = (
        ((start + jnp.arange(W)) < n_valid).astype(plan_xy.dtype)
        if p.exact_end_shrink else None
    )
    plan_ext = jnp.concatenate(
        [plan_xy, jnp.broadcast_to(plan_xy[-1], (W, 2))], axis=0)  # (P+W, 2)
    win_idx = jnp.arange(P)[:, None] + jnp.arange(W)[None, :]
    windows = plan_ext[win_idx].reshape(P, 2 * W)  # shared across the batch
    # HIGHEST precision is required for exactness: a default-precision
    # product (bf16 or TF32 operands) rounds ~100 m waypoint coordinates by
    # up to 0.25 m.
    oh = jax.nn.one_hot(start, P, dtype=plan_xy.dtype)
    w = jnp.matmul(oh, windows, precision=jax.lax.Precision.HIGHEST)
    w = w.reshape(W, 2)
    x_w, y_w = w[:, 0], w[:, 1]

    if p.chord_frame_fit:
        # Fit in a chord-aligned frame: the reference's raw y(x) fit
        # (LocalPlanner.cpp:101-117) is rank-deficient on north/south road
        # legs (constant x -> the QR least-norm solution collapses the
        # reference line to y ~ mean).  Rotating the window by the chord
        # heading keeps the fit a function for any road direction; the
        # returned waypoints/sample table are rotated BACK to the global
        # frame, so every consumer (tracking cost, closest-point field,
        # Frenet ref line, viz) is unchanged.  Off by default — the global
        # frame fit is the parity behavior.
        x0w, y0w = x_w[0], y_w[0]
        cx, cyw = x_w[-1] - x0w, y_w[-1] - y0w
        chord = jnp.sqrt(cx * cx + cyw * cyw)
        ok = chord > 1e-6
        cph = jnp.where(ok, cx / jnp.maximum(chord, 1e-6), 1.0)
        sph = jnp.where(ok, cyw / jnp.maximum(chord, 1e-6), 0.0)
        xr = cph * (x_w - x0w) + sph * (y_w - y0w)
        yr = -sph * (x_w - x0w) + cph * (y_w - y0w)

        coeffs, x_mid, x_scale = polyfit_scaled(xr, yr, p.poly_order, weights=fit_w)
        yr_fit = polyval_scaled(coeffs, x_mid, x_scale, xr)
        gx_w = x0w + cph * xr - sph * yr_fit
        gy_w = y0w + sph * xr + cph * yr_fit

        n = p.n_closest_samples
        sxr = xr[0] + (xr[-1] - xr[0]) / n * jnp.arange(n)
        syr = polyval_scaled_inv(coeffs, x_mid, 1.0 / x_scale, sxr)
        sx = x0w + cph * sxr - sph * syr
        sy = y0w + sph * sxr + cph * syr
        sxl, syl, sr = _local_channels(sx, sy, x0w, y0w, cph, sph)
        frame = jnp.stack(
            [xr[0], (xr[-1] - xr[0]) / n, x0w, y0w, cph, sph, x0w, y0w]
        )
        return LocalPlan(coeffs, x_mid, x_scale, gx_w, gy_w, sx, sy,
                         sxl, syl, sr, frame)

    coeffs, x_mid, x_scale = polyfit_scaled(x_w, y_w, p.poly_order, weights=fit_w)
    y_fit = polyval_scaled(coeffs, x_mid, x_scale, x_w)

    # densified table: n samples from x_w[0] stepping (x_w[-1]-x_w[0])/n
    n = p.n_closest_samples
    dx = (x_w[-1] - x_w[0]) / n
    sx = x_w[0] + dx * jnp.arange(n)
    sy = polyval_scaled_inv(coeffs, x_mid, 1.0 / x_scale, sx)

    zero = jnp.zeros_like(x_mid)
    one = jnp.ones_like(x_mid)
    sxl, syl, sr = _local_channels(sx, sy, x_w[0], y_w[0], one, zero)
    frame = jnp.stack([x_w[0], dx, zero, zero, one, zero, x_w[0], y_w[0]])
    return LocalPlan(coeffs, x_mid, x_scale, x_w, y_fit, sx, sy,
                     sxl, syl, sr, frame)


def find_closest_points(plan: LocalPlan, states: jax.Array) -> jax.Array:
    """Closest densified-sample point for each state (Constraints.cpp:24-59).

    Args:
      states: (N, 4) (or (4,)) query states.
    Returns:
      (N, 2) (or (2,)) closest [x, y] on the sample table.
    """
    single = states.ndim == 1
    Q = jnp.atleast_2d(states)
    S = plan.sample_x.shape[0]

    # Tournament over the expanded local-frame form d_rel = r_s - 2 p_l.s_l
    # (the |p_l|^2 term is constant per query): 2 multiply-adds per sample
    # instead of the 4-op (dx^2 + dy^2) evaluation.  Selection only — the
    # winner is re-checked exactly below.  Expression order mirrors the
    # GPU kernel's closest_point (ops/lm_pallas).
    qx, qy = plan.samp_frame[..., 6], plan.samp_frame[..., 7]
    cph, sph = plan.samp_frame[..., 4], plan.samp_frame[..., 5]
    dx0 = Q[:, 0] - qx
    dy0 = Q[:, 1] - qy
    xl = cph * dx0 + sph * dy0
    yl = cph * dy0 - sph * dx0
    n0 = -2.0 * xl
    n1 = -2.0 * yl
    d = (
        plan.sample_r[None, :] + n0[:, None] * plan.sample_xl[None, :]
    ) + n1[:, None] * plan.sample_yl[None, :]
    j = jnp.argmin(d, axis=-1)  # first-min tie-break

    # Exact refine: comparing {j-1, j, j+1} with the reference's exact
    # global (dx^2 + dy^2) restores Constraints.cpp:28-56 argmin semantics
    # for the generic near-tie — the expanded form's f32 rounding (~1e-4
    # m^2 in the local frame) vs the >= O(step^2) distance gap between
    # non-adjacent samples ALONG one path leg.  Known residual divergence:
    # a query near-equidistant (within that same ~1e-4 m^2 rounding) from
    # two DIFFERENT legs of a self-approaching window (S-curve folds) can
    # refine around the wrong leg's local minimum; geometrically this needs
    # two legs of the degree-5 fit within ~1 cm of equidistance inside one
    # 40 m window, which closed-loop tests never exhibit.
    # Fetch candidates with a one-hot matmul (whether a plain gather is
    # faster on the GPU is ROADMAP S4).  HIGHEST precision makes the dot
    # exact — at default precision (bf16 or TF32 operands) the fetched
    # coordinates round by up to ~0.25 m at CARLA-scale |x| ~ 100 m.
    cand = jnp.stack(
        [jnp.maximum(j - 1, 0), j, jnp.minimum(j + 1, S - 1)], axis=-1
    )  # (N, 3)
    table = jnp.stack([plan.sample_x, plan.sample_y], axis=-1)  # (S, 2)
    oh = jax.nn.one_hot(cand, S, dtype=Q.dtype)  # (N, 3, S)
    pts = jnp.matmul(oh, table, precision=jax.lax.Precision.HIGHEST)  # (N, 3, 2)
    dxg = Q[:, 0:1] - pts[..., 0]
    dyg = Q[:, 1:2] - pts[..., 1]
    dg = dxg * dxg + dyg * dyg  # (N, 3)

    # earliest-min merge (strict <, candidates in index order) — mirrors
    # the kernel's tournament merge so tie-breaking matches exactly
    def merge(a, b):
        m = b[0] < a[0]
        return (
            jnp.where(m, b[0], a[0]),
            jnp.where(m, b[1], a[1]),
            jnp.where(m, b[2], a[2]),
        )

    best = (dg[:, 0], pts[:, 0, 0], pts[:, 0, 1])
    best = merge(best, (dg[:, 1], pts[:, 1, 0], pts[:, 1, 1]))
    best = merge(best, (dg[:, 2], pts[:, 2, 0], pts[:, 2, 1]))
    out = jnp.stack([best[1], best[2]], axis=-1)
    return out[0] if single else out


def pad_global_plan(p: SolverParams, plan_xy, dtype=jnp.float32) -> tuple[jax.Array, jax.Array]:
    """Pad a (n, 2) waypoint array to the static (P, 2) shape + valid count.

    Padding repeats the final waypoint so out-of-range gathers stay sane.
    """
    plan_xy = jnp.asarray(plan_xy, dtype=dtype)
    n = plan_xy.shape[0]
    P = p.max_global_plan_points
    if n > P:
        raise ValueError(f"global plan has {n} > max_global_plan_points={P} points")
    pad = jnp.broadcast_to(plan_xy[-1], (P - n, 2))
    return jnp.concatenate([plan_xy, pad], axis=0), jnp.asarray(n, dtype=jnp.int32)
