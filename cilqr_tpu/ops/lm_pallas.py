"""Fused CILQR solve for the GPU: the whole LM loop in one Triton launch.

On XLA's route (``solver_batched.batched_optimize``) every LM iteration is a
``while_loop`` step wrapping two N-step ``lax.scan``s, and on a GPU each scan
step becomes its own small kernels, with the loop predicate read back every
iteration.  This kernel runs the entire solve (iLQR.cpp:201-245) for one
power-of-two block of scenario lanes per program:

  LM while_loop (per-block early exit once every lane has stopped)
    backward scan j = N-1 .. 0, derivatives built in registers per step:
      * closest point: first-minimum scan over the densified plan samples
        (Constraints.cpp:24-59), each sample regenerated from the lane's fit
        parameters in the expanded local-frame form of
        ``reference_path.find_closest_points``, then its exact
        {j-1, j, j+1} global refine;
      * tracking + control barriers (Constraints.cpp:86-175) with the
        state-dependent yaw-rate bounds;
      * obstacle ellipse barriers (Obstacle.cpp:39-112) from per-(obstacle,
        step) quadratic forms, read as broadcast scalars (shared obstacles);
      * the uncertainty-map barrier (models/uncertainty.py): each lane
        gathers the four bilinear corners from its own map (shared or
        per-scenario) in device memory;
      * the acceptance cost J (Constraints.cpp:534-561);
      * the Riccati step with the eigen-clamp regularized 2x2 inverse
        (iLQR.cpp:133-191);
    closed-loop forward rollout (iLQR.cpp:68-86) from the k/K gains;
    per-lane accept/reject and lambda update (iLQR.cpp:211-239).

Every state component is a ``(BLOCK,)`` vector: lanes are independent, so a
block needs no communication.  The Triton route has no scratch memory, so
the gains and the proposed trajectory live in extra global-memory outputs
that only the owning block touches.

Numerics: J is summed sequentially over the horizon here and by XLA's tree
order on the XLA route, so J can differ in the last bits and flip an accept
decision on an exact tie; trajectories agree to float32 rounding.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from cilqr_tpu.models import dynamics
from cilqr_tpu.utils.params import SolverParams

#: per-lane map-frame scalars: origin_x, origin_y, cos_yaw, sin_yaw,
#: first_x, first_y, resolution, lo_x, hi_x, lo_y, hi_y, then the map's
#: H - 1, W - 1, W and the lane stride of the flat values (H*W for
#: per-scenario maps, 0 for a shared one) — runtime data, so every map
#: shape and world kind runs the same compiled kernel
N_FRAME = 15

#: lanes per program (two warps, one lane per thread): a batch pads to a
#: multiple of it
BLOCK = 64


def prep_obstacles(p: SolverParams, obs, dtype=jnp.float32) -> jax.Array:
    """Precompute per-(m, j) global-frame ellipse quadratic forms.

    Folds the rotation of Obstacle.cpp:55-63 into a symmetric 2x2 G so the
    kernel's per-step work is 2 quadratic forms per obstacle disc.
    Returns (M*6, N): rows [g11, g12, g22, px, py, mask] per obstacle.
    Without obstacles: ``p.max_obstacles`` all-zero rows (G = 0 and mask 0
    add exact zeros).
    """
    N = p.horizon
    if obs is None:
        return jnp.zeros((p.max_obstacles * 6, N), dtype)
    dims = obs.dims[:, :N].astype(dtype)  # (M, N, 2)
    pos = obs.pos[:, :N].astype(dtype)    # (M, N, 4)
    M = dims.shape[0]
    ov, oth = pos[..., 2], pos[..., 3]
    a = dims[..., 0] / 2.0 + jnp.abs(ov * jnp.cos(oth)) * p.t_safe + p.s_safe_a + p.ego_rad
    b = dims[..., 1] / 2.0 + jnp.abs(ov * jnp.sin(oth)) * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
    ia2 = 1.0 / (a * a)
    ib2 = 1.0 / (b * b)
    co, so = jnp.cos(oth), jnp.sin(oth)
    g11 = co * co * ia2 + so * so * ib2
    g12 = co * so * (ia2 - ib2)
    g22 = so * so * ia2 + co * co * ib2
    mask = jnp.broadcast_to(obs.mask.astype(dtype)[:, None], (M, N))
    payload = jnp.stack([g11, g12, g22, pos[..., 0], pos[..., 1], mask], axis=1)
    return payload.reshape(M * 6, N)


def prep_unc_map(m, B: int, dtype=jnp.float32):
    """Flat map values + per-lane frame scalars for the in-kernel sampler.

    ``m`` is shared (values (H, W)) or per-scenario (values (B, H, W)).
    Returns (flat values (B*H*W,) or (H*W,), frame (N_FRAME, B)).  Without a
    map: a 2x2 zero map whose bounds are empty (lo > hi), so the barrier is
    an exact zero."""
    if m is None:
        frame = jnp.zeros((N_FRAME, B), dtype)
        frame = frame.at[6].set(1.0)                    # resolution
        frame = frame.at[7].set(1.0).at[8].set(-1.0)   # lo_x > hi_x
        frame = frame.at[11:14].set(jnp.asarray([1.0, 1.0, 2.0], dtype)[:, None])
        return jnp.zeros((4,), dtype), frame
    batched = m.values.ndim == 3
    H, W = m.values.shape[-2:]
    if batched and B * H * W >= 2**31:
        raise ValueError(f"{B} maps of {H}x{W} overflow int32 gather indices")
    g = m.geom
    res = jnp.broadcast_to(g.resolution, g.center.shape[:-1])
    first = g.center + 0.5 * g.length - 0.5 * res[..., None]
    lo = g.center - 0.5 * g.length
    hi = g.center + 0.5 * g.length
    frame = jnp.stack([
        m.origin_xy[..., 0], m.origin_xy[..., 1],
        jnp.cos(m.origin_yaw), jnp.sin(m.origin_yaw),
        first[..., 0], first[..., 1], res,
        lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1],
    ]).astype(dtype).reshape(11, -1)
    dims = jnp.asarray([H - 1, W - 1, W, H * W if batched else 0], dtype)
    frame = jnp.concatenate(
        [jnp.broadcast_to(frame, (11, B)), jnp.broadcast_to(dims[:, None], (4, B))])
    return m.values.astype(dtype).reshape(-1), frame


def _fit_payload(plans) -> jax.Array:
    """(poly_order+11, B) payload: coeffs, x_mid, x_scale, samp_frame."""
    return jnp.concatenate(
        [
            plans.coeffs,
            plans.x_mid[:, None],
            plans.x_scale[:, None],
            plans.samp_frame,
        ],
        axis=-1,
    ).astype(jnp.float32).T


def _padd(a, b):
    """a + b skipping Python-literal zeros (sparse derivative assembly)."""
    if isinstance(a, float) and a == 0.0:
        return b
    if isinstance(b, float) and b == 0.0:
        return a
    return a + b


def _opt_kernel(p: SolverParams, S: int, M: int,
                fit_ref, X0_ref, U0_ref, obs_ref, frame_ref, umap_ref,
                X_ref, U_ref, J_ref, lamb_ref, it_ref, fail_ref,
                Xp_ref, Up_ref, k_ref, K_ref):
    f32 = jnp.float32
    N = p.horizon
    dt = float(p.timestep)
    wpos, wvel = float(p.w_pos), float(p.w_vel)
    wacc, wyr = float(p.w_acc), float(p.w_yawrate)
    vdes = float(p.desired_speed)
    q1a, q2a = float(p.q1_acc), float(p.q2_acc)
    q1y, q2y = float(p.q1_yawrate), float(p.q2_yawrate)
    tan_hi = math.tan(p.steer_angle_max) / p.wheelbase
    tan_lo = math.tan(p.steer_angle_min) / p.wheelbase
    wobs = float(p.w_obstacle)
    q1f, q2f = float(p.q1_front), float(p.q2_front)
    q1r, q2r = float(p.q1_rear), float(p.q2_rear)
    wunc = float(p.w_uncertainty)
    q1u, q2u = float(p.q1_uncertainty), float(p.q2_uncertainty)
    efront, erear = float(p.ego_front), float(p.ego_rear)
    zero = jnp.zeros((BLOCK,), f32)

    # fit parameters (reference_path.get_local_plan's table generator)
    ncoef = p.poly_order + 1
    cs = [fit_ref[i, :] for i in range(ncoef)]
    x_mid = fit_ref[ncoef, :]
    inv_xscale = 1.0 / fit_ref[ncoef + 1, :]
    x0r, dr, ox, oy, cph, sph, qx, qy = (
        fit_ref[ncoef + 2 + i, :] for i in range(8))

    def global_sample(s):
        """Global-frame sample (x, y) at float index s: the op order of
        get_local_plan's sample table (polyval_scaled_inv + rotate back)."""
        sxr = x0r + dr * s
        t = (sxr - x_mid) * inv_xscale
        r = zero
        for c in reversed(cs):
            r = r * t + c
        return ox + cph * sxr - sph * r, oy + sph * sxr + cph * r

    def closest_point(x0, x1):
        """find_closest_points for one query per lane."""
        dx0 = x0 - qx
        dy0 = x1 - qy
        xl = cph * dx0 + sph * dy0
        yl = cph * dy0 - sph * dx0
        n0 = -2.0 * xl
        n1 = -2.0 * yl

        def scan(s, carry):
            best_d, best_s = carry
            sf = s.astype(f32)
            sxg, syg = global_sample(sf)
            ddx = sxg - qx
            ddy = syg - qy
            sxl = cph * ddx + sph * ddy
            syl = cph * ddy - sph * ddx
            d = (sxl * sxl + syl * syl + n0 * sxl) + n1 * syl
            m = d < best_d  # strict: the first minimum wins (argmin)
            return jnp.where(m, d, best_d), jnp.where(m, sf, best_s)

        _, j = jax.lax.fori_loop(
            0, S, scan, (jnp.full((BLOCK,), jnp.inf, f32), zero))

        def exact(s):
            sxg, syg = global_sample(s)
            dxg = x0 - sxg
            dyg = x1 - syg
            return dxg * dxg + dyg * dyg, sxg, syg

        best = exact(jnp.maximum(j - 1.0, 0.0))
        for cand in (j, jnp.minimum(j + 1.0, float(S - 1))):
            e = exact(cand)
            m = e[0] < best[0]
            best = tuple(jnp.where(m, a, b) for a, b in zip(e, best))
        return best[1], best[2]

    fr = [frame_ref[i, :] for i in range(N_FRAME)]
    mox, moy, cyw, syw, fx0, fy0, mres, lox, hix, loy, hiy, hm1, wm1 = fr[:13]
    inv = -1.0 / mres
    W = fr[13].astype(jnp.int32)
    lane = pl.program_id(0) * BLOCK + jax.lax.broadcasted_iota(
        jnp.int32, (BLOCK,), 0)
    base = lane * fr[14].astype(jnp.int32)

    def unc_sample(x0, x1):
        """uncertainty.uncertainty_sample: (e, gx, gy) from the lane's map."""
        d0 = x0 - mox
        d1 = x1 - moy
        lx = cyw * d0 + syw * d1
        ly = -syw * d0 + cyw * d1
        inside = (lx >= lox) & (lx <= hix) & (ly >= loy) & (ly <= hiy)
        fi = jnp.minimum(jnp.maximum((fx0 - lx) / mres, 0.0), hm1)
        fj = jnp.minimum(jnp.maximum((fy0 - ly) / mres, 0.0), wm1)
        # floor, clipped to H-2 / W-2 so the +1 corners stay in the map
        i0f = jnp.minimum(jnp.floor(fi), hm1 - 1.0)
        j0f = jnp.minimum(jnp.floor(fj), wm1 - 1.0)
        ti = fi - i0f
        tj = fj - j0f
        idx = base + i0f.astype(jnp.int32) * W + j0f.astype(jnp.int32)
        v00 = umap_ref[idx]
        v01 = umap_ref[idx + 1]
        v10 = umap_ref[idx + W]
        v11 = umap_ref[idx + (W + 1)]
        v0 = v00 * (1 - tj) + v01 * tj
        v1 = v10 * (1 - tj) + v11 * tj
        val = v0 * (1 - ti) + v1 * ti
        gci = (v1 - v0) * inv / 100.0
        gcj = ((v01 - v00) * (1 - ti) + (v11 - v10) * ti) * inv / 100.0
        gx = cyw * gci - syw * gcj
        gy = syw * gci + cyw * gcj
        e = q1u * jnp.exp(q2u * (val / 100.0))
        return jnp.where(inside, e, 0.0), gx, gy

    def step_derivs(X, U, j):
        """(l_x, sparse l_xx, l_u, l_uu, J_step) at timestep j: the fused
        form of costs.all_cost_derivs_and_J for one step."""
        x0 = X[j, 0, :]
        x1 = X[j, 1, :]
        x2 = X[j, 2, :]
        x3 = X[j, 3, :]
        u0 = U[j, 0, :]
        u1 = U[j, 1, :]

        cxp, cyp = closest_point(x0, x1)
        ex = x0 - cxp
        ey = x1 - cyp
        ev = x2 - vdes
        lx0 = (2.0 * wpos) * ex
        lx1 = (2.0 * wpos) * ey
        lx2 = (2.0 * wvel) * ev

        cth = jnp.cos(x3)
        sth = jnp.sin(x3)
        discs = (
            (x0 + cth * efront, x1 + sth * efront, q1f, q2f),
            (x0 - cth * erear, x1 - sth * erear, q1r, q2r),
        )

        def obstacle(m, acc):
            lx0, lx1, s00, s01, s11 = acc
            g11, g12, g22, px, py, msk = (
                obs_ref[m * 6 + i, j] for i in range(6))
            for (ecx, ecy, q1d, q2d) in discs:
                dx = ecx - px
                dy = ecy - py
                gdx = g11 * dx + g12 * dy
                gdy = g12 * dx + g22 * dy
                cv = 1.0 - (dx * gdx + dy * gdy)
                e = (q1d * msk) * jnp.exp(q2d * cv)
                gx = -2.0 * gdx
                gy = -2.0 * gdy
                s1 = (wobs * q2d) * e
                s2 = (wobs * q2d * q2d) * e
                lx0 = lx0 + s1 * gx
                lx1 = lx1 + s1 * gy
                s00 = s00 + s2 * gx * gx
                s01 = s01 + s2 * gx * gy
                s11 = s11 + s2 * gy * gy
            return lx0, lx1, s00, s01, s11

        lx0, lx1, s00, s01, s11 = jax.lax.fori_loop(
            0, M, obstacle, (lx0, lx1, zero, zero, zero))

        e, gx, gy = unc_sample(x0, x1)
        s1 = (wunc * q2u) * e
        s2 = (wunc * q2u * q2u) * e
        lx0 = lx0 + s1 * gx
        lx1 = lx1 + s1 * gy
        s00 = s00 + s2 * gx * gx
        s01 = s01 + s2 * gx * gy
        s11 = s11 + s2 * gy * gy

        # control barriers (Constraints.cpp:86-137), yaw-rate bounds at the
        # concurrent state (Constraints.cpp:119-121)
        b1 = q1a * jnp.exp(q2a * (u0 - p.acc_max))
        b2 = q1a * jnp.exp(q2a * (p.acc_min - u0))
        b3 = q1y * jnp.exp(q2y * (u1 - x2 * tan_hi))
        b4 = q1y * jnp.exp(q2y * (x2 * tan_lo - u1))
        lu0 = q2a * (b1 - b2) + (2.0 * wacc) * u0
        lu1 = q2y * (b3 - b4) + (2.0 * wyr) * u1
        luu00 = (q2a * q2a) * (b1 + b2) + 2.0 * wacc
        luu11 = (q2y * q2y) * (b3 + b4) + 2.0 * wyr

        Jstep = (
            wpos * (ex * ex + ey * ey)
            + wvel * (ev * ev)
            + wacc * (u0 * u0)
            + wyr * (u1 * u1)
        )
        lxx = (2.0 * wpos + s00, s01, 2.0 * wpos + s11, 2.0 * wvel)
        return (lx0, lx1, lx2), lxx, (lu0, lu1), (luu00, luu11), Jstep

    def iteration(lamb):
        """Derivatives + backward Riccati (gains into k/K) + forward rollout
        of the current X/U into Xp/Up.  Returns J of the current X/U and
        whether every gain is finite."""

        def backward_body(t, carry):
            Vx, Vxx_flat, Jacc, ok = carry
            j = N - 1 - t
            (lx0, lx1, lx2), (a00, a01, a11, a22), (lu0, lu1), (luu00, luu11), Jstep = (
                step_derivs(X_ref, U_ref, j))
            Jacc = Jacc + Jstep
            # V seeded from the running cost at step N-1, which re-enters
            # the recursion at j=N-1 (iLQR.cpp:108-113,133)
            seed_x = (lx0, lx1, lx2, zero)
            seed_xx = (a00, a01, zero, zero, a01, a11, zero, zero,
                       zero, zero, a22, zero, zero, zero, zero, zero)
            first = t == 0
            Vx = [jnp.where(first, a, b) for a, b in zip(seed_x, Vx)]
            Vxx_flat = [jnp.where(first, a, b) for a, b in zip(seed_xx, Vxx_flat)]
            Vxx = [[Vxx_flat[4 * r + c] for c in range(4)] for r in range(4)]

            # jacobian ingredients at the successor state (iLQR.cpp:102-106)
            v = X_ref[j + 1, 2, :]
            th = X_ref[j + 1, 3, :]
            a = U_ref[j, 0, :]
            c = jnp.cos(th)
            s = jnp.sin(th)
            ds = v * dt + 0.5 * a * dt * dt
            dtc = dt * c
            dts = dt * s
            sds = s * ds
            cds = c * ds
            hdt2c = 0.5 * dt * dt * c
            hdt2s = 0.5 * dt * dt * s

            # Q_x = l_x + fx^T V_x (fx rows [1,0,dtc,-sds],[0,1,dts,cds],e2,e3)
            Qx = [
                lx0 + Vx[0],
                lx1 + Vx[1],
                lx2 + dtc * Vx[0] + dts * Vx[1] + Vx[2],
                -sds * Vx[0] + cds * Vx[1] + Vx[3],  # l_x[3] == 0
            ]
            Qu = [
                lu0 + hdt2c * Vx[0] + hdt2s * Vx[1] + dt * Vx[2],
                lu1 + dt * Vx[3],
            ]

            def left_fx(col):
                return [
                    col[0],
                    col[1],
                    dtc * col[0] + dts * col[1] + col[2],
                    -sds * col[0] + cds * col[1] + col[3],
                ]

            Mx = [[None] * 4 for _ in range(4)]
            for a2 in range(4):
                mcol = left_fx([Vxx[r][a2] for r in range(4)])
                for b in range(4):
                    Mx[b][a2] = mcol[b]

            # Q_xx = l_xx + M fx with the sparse l_xx
            lxx_mat = [
                [a00, a01, 0.0, 0.0],
                [a01, a11, 0.0, 0.0],
                [0.0, 0.0, a22, 0.0],
                [0.0, 0.0, 0.0, 0.0],
            ]
            Qxx = [[None] * 4 for _ in range(4)]
            for b1 in range(4):
                Qxx[b1][0] = _padd(lxx_mat[b1][0], Mx[b1][0])
                Qxx[b1][1] = _padd(lxx_mat[b1][1], Mx[b1][1])
                Qxx[b1][2] = _padd(
                    lxx_mat[b1][2], dtc * Mx[b1][0] + dts * Mx[b1][1] + Mx[b1][2])
                Qxx[b1][3] = _padd(
                    lxx_mat[b1][3], -sds * Mx[b1][0] + cds * Mx[b1][1] + Mx[b1][3])

            # N2 = fu^T V_xx (2x4); Q_ux = N2 fx; Q_uu = l_uu + N2 fu
            N2 = [
                [hdt2c * Vxx[0][a2] + hdt2s * Vxx[1][a2] + dt * Vxx[2][a2]
                 for a2 in range(4)],
                [dt * Vxx[3][a2] for a2 in range(4)],
            ]
            Qux = [[None] * 4 for _ in range(2)]
            for r in range(2):
                Qux[r][0] = N2[r][0]
                Qux[r][1] = N2[r][1]
                Qux[r][2] = dtc * N2[r][0] + dts * N2[r][1] + N2[r][2]
                Qux[r][3] = -sds * N2[r][0] + cds * N2[r][1] + N2[r][3]
            Quu00 = luu00 + hdt2c * N2[0][0] + hdt2s * N2[0][1] + dt * N2[0][2]
            Quu01 = dt * N2[0][3]  # l_uu off-diagonal == 0
            Quu10 = hdt2c * N2[1][0] + hdt2s * N2[1][1] + dt * N2[1][2]
            Quu11 = luu11 + dt * N2[1][3]

            # closed-form 2x2 eig clamp+shift inverse (iLQR.cpp:155-175,
            # ops/eig2x2.py)
            bsym = Quu01
            half_tr = 0.5 * (Quu00 + Quu11)
            half_df = 0.5 * (Quu00 - Quu11)
            disc = jnp.sqrt(half_df * half_df + bsym * bsym)
            w_lo = half_tr - disc
            w_hi = half_tr + disc
            safe = jnp.abs(bsym) > 1.1920929e-07 * (jnp.abs(Quu00) + jnp.abs(Quu11))
            a_ge = Quu00 >= Quu11
            vx1 = jnp.where(safe, bsym, jnp.where(a_ge, 1.0, 0.0))
            vy1 = jnp.where(safe, w_hi - Quu00, jnp.where(a_ge, 0.0, 1.0))
            nrm = jax.lax.rsqrt(vx1 * vx1 + vy1 * vy1)
            vx1 = vx1 * nrm
            vy1 = vy1 * nrm
            i_hi = 1.0 / (jnp.maximum(w_hi, 0.0) + lamb)
            i_lo = 1.0 / (jnp.maximum(w_lo, 0.0) + lamb)
            I00 = i_hi * vx1 * vx1 + i_lo * vy1 * vy1
            I01 = (i_hi - i_lo) * vx1 * vy1
            I11 = i_hi * vy1 * vy1 + i_lo * vx1 * vx1

            k0 = -(I00 * Qu[0] + I01 * Qu[1])
            k1 = -(I01 * Qu[0] + I11 * Qu[1])
            Krow = [[None] * 4 for _ in range(2)]
            for b in range(4):
                Krow[0][b] = -(I00 * Qux[0][b] + I01 * Qux[1][b])
                Krow[1][b] = -(I01 * Qux[0][b] + I11 * Qux[1][b])

            t0 = Quu00 * k0 + Quu01 * k1
            t1 = Quu10 * k0 + Quu11 * k1
            Vx_n = tuple(Qx[b] - (Krow[0][b] * t0 + Krow[1][b] * t1)
                         for b in range(4))
            Wm = [
                [Quu00 * Krow[0][b] + Quu01 * Krow[1][b] for b in range(4)],
                [Quu10 * Krow[0][b] + Quu11 * Krow[1][b] for b in range(4)],
            ]
            Vxx_n = tuple(
                Qxx[b1][b2] - (Krow[0][b1] * Wm[0][b2] + Krow[1][b1] * Wm[1][b2])
                for b1 in range(4)
                for b2 in range(4)
            )

            k_ref[j, 0, :] = k0
            k_ref[j, 1, :] = k1
            gains = jnp.isfinite(k0) & jnp.isfinite(k1)
            for r in range(2):
                for b in range(4):
                    K_ref[j, 4 * r + b, :] = Krow[r][b]
                    gains = gains & jnp.isfinite(Krow[r][b])
            return (Vx_n, Vxx_n, Jacc, jnp.where(gains, ok, 0.0))

        _, _, Jacc, ok = jax.lax.fori_loop(
            0, N, backward_body, ((zero,) * 4, (zero,) * 16, zero, zero + 1.0))

        # closed-loop rollout u = U + k + K (x - X); x' = step(x, u) with the
        # Model.cpp:17-30 clamps
        for i in range(4):
            Xp_ref[0, i, :] = X_ref[0, i, :]

        def forward_body(j, x):
            x0, x1, x2, x3 = x
            dx = [x0 - X_ref[j, 0, :], x1 - X_ref[j, 1, :],
                  x2 - X_ref[j, 2, :], x3 - X_ref[j, 3, :]]
            u0 = U_ref[j, 0, :] + k_ref[j, 0, :]
            u1 = U_ref[j, 1, :] + k_ref[j, 1, :]
            for b in range(4):
                u0 = u0 + K_ref[j, b, :] * dx[b]
                u1 = u1 + K_ref[j, 4 + b, :] * dx[b]
            Up_ref[j, 0, :] = u0
            Up_ref[j, 1, :] = u1
            acc = jnp.clip(u0, p.acc_min, p.acc_max)
            yr = jnp.clip(u1, x2 * tan_lo, x2 * tan_hi)
            ds = x2 * dt + 0.5 * acc * dt * dt
            nx = (
                x0 + jnp.cos(x3) * ds,
                x1 + jnp.sin(x3) * ds,
                jnp.clip(x2 + acc * dt, 0.0, p.speed_max),
                x3 + yr * dt,
            )
            for i in range(4):
                Xp_ref[j + 1, i, :] = nx[i]
            return nx

        jax.lax.fori_loop(
            0, N, forward_body, tuple(X_ref[0, i, :] for i in range(4)))
        return Jacc, ok > 0.5

    def copy_in(j, c):
        for i in range(4):
            X_ref[j, i, :] = X0_ref[j, i, :]
        for i in range(2):
            U_ref[j, i, :] = U0_ref[j, i, :]
        return c

    jax.lax.fori_loop(0, N, copy_in, 0)
    for i in range(4):
        X_ref[N, i, :] = X0_ref[N, i, :]

    def lm_cond(carry):
        n_it, _, _, _, done, _ = carry
        return (n_it < p.max_iterations) & (jnp.min(done) < 0.5)

    def lm_body(carry):
        n_it, J_old, lamb, it, done, failed = carry
        J_new, ok = iteration(lamb)
        # failed backward pass: stop, keep X/U/lambda (solver.optimize)
        accept = (J_new < J_old) & ok
        upd = done < 0.5
        take = upd & accept

        def merge(j, c):
            for i in range(4):
                X_ref[j, i, :] = jnp.where(take, Xp_ref[j, i, :], X_ref[j, i, :])
            for i in range(2):
                U_ref[j, i, :] = jnp.where(take, Up_ref[j, i, :], U_ref[j, i, :])
            return c

        jax.lax.fori_loop(0, N, merge, 0)
        for i in range(4):
            X_ref[N, i, :] = jnp.where(take, Xp_ref[N, i, :], X_ref[N, i, :])
        lamb_n = jnp.where(
            ok, jnp.where(accept, lamb / p.lamb_factor, lamb * p.lamb_factor), lamb)
        stop = jnp.where(
            ok,
            jnp.where(
                accept,
                jnp.where(jnp.abs(J_new - J_old) < p.tolerance, 1.0, 0.0),
                jnp.where(lamb_n > p.lamb_max, 1.0, 0.0),
            ),
            1.0,
        )
        return (
            n_it + 1,
            jnp.where(upd, J_new, J_old),
            jnp.where(upd, lamb_n, lamb),
            jnp.where(upd, it + 1, it),
            jnp.maximum(done, jnp.where(upd, stop, 0.0)),
            jnp.where(upd & ~ok, 1, failed),
        )

    carry0 = (
        jnp.int32(0),
        jnp.full((BLOCK,), jnp.finfo(f32).max, f32),
        jnp.full((BLOCK,), p.lamb_init, f32),
        jnp.zeros((BLOCK,), jnp.int32),
        zero,
        jnp.zeros((BLOCK,), jnp.int32),
    )
    _, J_fin, lamb_fin, it_fin, _, fail_fin = jax.lax.while_loop(
        lm_cond, lm_body, carry0)
    J_ref[...] = J_fin
    lamb_ref[...] = lamb_fin
    it_ref[...] = it_fin
    fail_ref[...] = fail_fin


def fused_optimize(
    p: SolverParams,
    plans,
    x0s: jax.Array,
    U_init: jax.Array,
    obstacles=None,
    unc_map=None,
    interpret: bool = False,
):
    """LM loop (iLQR.cpp:201-245 semantics, per-lane masks) in one launch.

    Same signature and return as ``solver_batched.batched_optimize``, for
    shared obstacles and a shared or per-scenario uncertainty map; every
    world kind runs the same compiled kernel (absent obstacles and maps add
    exact zeros).  The batch is padded to a multiple of ``BLOCK`` with
    copies of lane 0 (sliced off again).  ``interpret=True`` runs the Pallas
    interpreter (the CPU tests); otherwise the kernel compiles for the GPU
    through Triton.
    """
    if obstacles is not None and obstacles.pos.ndim != 3:
        raise ValueError("the fused kernel takes shared obstacles only")
    B = x0s.shape[0]
    Bp = -(-B // BLOCK) * BLOCK
    f32 = jnp.float32
    N = p.horizon
    S = p.n_closest_samples

    def pad(a):
        if Bp == B:
            return a
        return jnp.concatenate(
            [a, jnp.broadcast_to(a[:1], (Bp - B,) + a.shape[1:])], axis=0)

    X0 = jax.vmap(lambda e, u: dynamics.rollout(p, e, u))(x0s, U_init)
    X0_t = jnp.transpose(pad(X0.astype(f32)), (1, 2, 0))      # (N+1, 4, Bp)
    U0_t = jnp.transpose(pad(U_init.astype(f32)), (1, 2, 0))  # (N, 2, Bp)
    fit = _fit_payload(jax.tree.map(pad, plans))               # (C, Bp)
    obs = prep_obstacles(p, obstacles, f32)
    if unc_map is not None and unc_map.values.ndim == 3:
        unc_map = jax.tree.map(pad, unc_map)
    umap, frame = prep_unc_map(unc_map, Bp, f32)

    kern = functools.partial(_opt_kernel, p, S, obs.shape[0] // 6)
    lanes = lambda *lead: pl.BlockSpec(
        lead + (BLOCK,), lambda g: (0,) * len(lead) + (g,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda g: (0,) * a.ndim)
    C = fit.shape[0]
    out_shapes = [
        ((N + 1, 4), f32), ((N, 2), f32), ((), f32), ((), f32), ((), jnp.int32),
        ((), jnp.int32), ((N + 1, 4), f32), ((N, 2), f32), ((N, 2), f32), ((N, 8), f32),
    ]
    outs = pl.pallas_call(
        kern,
        grid=(Bp // BLOCK,),
        in_specs=[
            lanes(C), lanes(N + 1, 4), lanes(N, 2), whole(obs),
            lanes(N_FRAME), whole(umap),
        ],
        out_specs=[lanes(*lead) for lead, _ in out_shapes],
        out_shape=[jax.ShapeDtypeStruct(lead + (Bp,), dt) for lead, dt in out_shapes],
        compiler_params=pltriton.CompilerParams(num_warps=BLOCK // 32,
                                                num_stages=1),
        interpret=interpret,
        backend="triton",
        name="cilqr_lm_solve",
    )(fit, X0_t, U0_t, obs, frame, umap)
    X_t, U_t, J, lamb, it, failed = outs[:6]
    X = jnp.transpose(X_t, (2, 0, 1))[:B]
    U = jnp.transpose(U_t, (2, 0, 1))[:B]
    return X, U, it[:B], J[:B], lamb[:B], failed[:B] > 0
