"""Uncertainty propagation for the GPU: one Triton program per map tile.

The XLA form (``costmap.propagate_uncertainty_reference``) is a ``fori_loop``
over the (2R+1)^2 window offsets; under ``vmap`` each offset re-reads the
prior, validity and covariance planes of every scenario from device memory
and rewrites num/den.  This kernel instead runs one program per
(scenario, TR x TC output tile): it loads the tile's covariance fields once,
then walks every window offset on chip, reading the shifted prior tile from
the tile's halo (a few KB, served from L1/L2 after the first touch).

Semantics are those of the reference, offset for offset (di outer, dj
inner, the same weights and inside-ellipse test), with two exact savings:

* per row tile the window radius is the band radius from the static
  ``costmap.BandPlan`` (a loop bound), not the worst-case map corner;
* offsets outside each band's disc radius are skipped (they carry w = 0).

The gathered prior is zero-padded by the largest radius, so every load is
in bounds; the in-map test uses the global cell ids, as the reference's
validity plane does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from cilqr_tpu.ops import costmap as costmap_mod
from cilqr_tpu.ops import gridmap
from cilqr_tpu.utils.params import CostmapParams

#: output tile (rows, cols): powers of two, 8 rows = one band of the default
#: band plan
TR, TC = 8, 16


def tile_tables(band_plan, rows: int, window_radius: int):
    """Per-row-tile window radius (int32) and squared disc radius (f32).

    A tile covering rows of several bands takes their largest radius;
    without a disc radius the cut is the full square (2 R^2)."""
    n_rt = -(-rows // TR)
    radius = np.zeros(n_rt, np.int32)
    disc2 = np.zeros(n_rt, np.float32)
    if band_plan is None:
        bands = ((0, rows, window_radius),)
        discs = (None,)
    else:
        bands = band_plan.bands
        discs = band_plan.disc_radii or (None,) * len(bands)
    for (r0, br, Rb), rd in zip(bands, discs):
        d2 = 2.0 * Rb * Rb if rd is None else float(rd) ** 2
        for t in range(r0 // TR, -(-(r0 + br) // TR)):
            radius[t] = max(radius[t], Rb)
            disc2[t] = max(disc2[t], d2)
    return radius, disc2


def _kernel(res: float, chi2: float, rows: int, cols: int, P: int,
            prior_batched: bool,
            radius_ref, disc2_ref, prior_ref, sx_ref, sy_ref, rho_ref, psd_ref,
            out_ref):
    f32 = jnp.float32
    b = pl.program_id(0)
    ti = pl.program_id(1)
    tj = pl.program_id(2)
    r0 = ti * TR
    c0 = tj * TC
    tile = lambda ref: ref[b, pl.ds(r0, TR), pl.ds(c0, TC)]
    sx, sy, rho, psd = tile(sx_ref), tile(sy_ref), tile(rho_ref), tile(psd_ref)

    def prior_at(i, j):
        """Prior tile at row/col offset (i, j) into the P-padded prior."""
        if prior_batched:
            return prior_ref[b, pl.ds(r0 + i, TR), pl.ds(c0 + j, TC)]
        return prior_ref[pl.ds(r0 + i, TR), pl.ds(c0 + j, TC)]

    one_m_rho2 = 1.0 - rho * rho
    inv_det2 = 1.0 / (2.0 * one_m_rho2)
    thresh = chi2 * one_m_rho2
    inv_sx = 1.0 / sx
    inv_sy = 1.0 / sy
    two_rho = rho + rho
    row_id = r0 + jax.lax.broadcasted_iota(jnp.int32, (TR, TC), 0)
    col_id = c0 + jax.lax.broadcasted_iota(jnp.int32, (TR, TC), 1)

    R = radius_ref[ti]
    d2 = disc2_ref[ti]
    Rf = R.astype(f32)

    # offsets (di, dj) = (a - R, c - R) walked with non-negative a, c in
    # [0, 2R], so no negative integer meets an index or a conversion
    def di_body(a, acc):
        af = a.astype(f32)
        # dj range inside the disc; over-inclusion is exact (w = 0 there)
        m = jnp.floor(jnp.sqrt(jnp.maximum(d2 - (af - Rf) * (af - Rf), 0.0)) + 0.5)
        m = jnp.minimum(m.astype(jnp.int32), R)
        zx = ((Rf - af) * res) * inv_sx
        row_ok = (row_id + a >= R) & (row_id + a < rows + R)

        def dj_body(c, acc):
            num, den = acc
            zy = ((Rf - c.astype(f32)) * res) * inv_sy
            q = (zx - two_rho * zy) * zx + zy * zy
            in_map = row_ok & (col_id + c >= R) & (col_id + c < cols + R)
            f = jnp.exp(-q * inv_det2)
            w = jnp.where((q <= thresh) & in_map, f, 0.0)
            return num + w * prior_at(a + (P - R), c + (P - R)), den + w

        return jax.lax.fori_loop(R - m, R + m + 1, dj_body, acc)

    zero = jnp.zeros((TR, TC), f32)
    num, den = jax.lax.fori_loop(0, 2 * R + 1, di_body, (zero, zero))
    good = (psd > 0.0) & (den > 0.0)
    # the weighted average of occupancies in [0, 100] is in [0, 100];
    # clamp the float32 rounding overshoot
    out_ref[b, pl.ds(r0, TR), pl.ds(c0, TC)] = jnp.where(
        good, jnp.clip(num / den, 0.0, 100.0), prior_at(P, P))


def prep_fields(cp: CostmapParams, geom, ego_yaw, sigmas, rows: int, cols: int):
    """Per-scenario covariance fields (sx, sy, rho, psd), f32, (B, rows, cols).

    Any of (geom, ego_yaw, sigmas) may carry a leading scenario axis:
    Monte-Carlo batches sigmas over a shared map frame; the full-stack
    closed loop batches the frame (each scenario's own corridor-centered
    geometry and yaw) with the configured shared sigmas (sigmas=None)."""
    geom_ax = 0 if geom.center.ndim == 2 else None
    yaw_ax = 0 if jnp.ndim(ego_yaw) == 1 else None
    sig_ax = 0 if sigmas is not None else None
    if geom_ax is None and yaw_ax is None and sig_ax is None:
        raise ValueError("no batched input among (geom, ego_yaw, sigmas)")

    def fields(geom1, yaw1, sg):
        xs, ys = gridmap.cell_positions(geom1, rows, cols)
        sig = None if sg is None else (sg[0], sg[1], sg[2])
        sx, sy, rho = costmap_mod.cell_sigma_rho(
            cp, xs, ys, yaw1, sigmas=sig
        )
        psd = (jnp.abs(rho) < 1.0).astype(jnp.float32)
        rho = jnp.where(psd > 0, rho, 0.0).astype(jnp.float32)
        return sx.astype(jnp.float32), sy.astype(jnp.float32), rho, psd

    return jax.vmap(fields, in_axes=(geom_ax, yaw_ax, sig_ax))(
        geom, ego_yaw, sigmas
    )


def propagate_batched(
    cp: CostmapParams,
    prior: jax.Array,
    geom: gridmap.GridGeom,
    ego_yaw: jax.Array,
    sigmas=None,
    band_plan=None,
    interpret: bool = False,
) -> jax.Array:
    """Batched propagation: (B, rows, cols) uncertainty maps.

    ``prior`` is shared (rows, cols) or per-scenario (B, rows, cols); any of
    (geom, ego_yaw, sigmas (B, 3)) may carry the scenario axis (see
    ``prep_fields``).  ``band_plan`` (``costmap.make_band_plan[_bounds]``)
    sets the per-row-tile window; without one every tile uses
    ``cp.window_radius``.  ``interpret=True`` runs the Pallas interpreter
    (the CPU tests); otherwise the kernel compiles for the GPU through
    Triton."""
    rows, cols = prior.shape[-2:]
    if band_plan is not None:
        costmap_mod.check_band_plan(band_plan, rows)
    sx, sy, rho, psd = prep_fields(cp, geom, ego_yaw, sigmas, rows, cols)
    B = sx.shape[0]
    radius, disc2 = tile_tables(band_plan, rows, cp.window_radius)
    P = int(radius.max())
    rp_, cp_ = -(-rows // TR) * TR, -(-cols // TC) * TC
    grow = lambda a, v: jnp.pad(
        a, ((0, 0), (0, rp_ - rows), (0, cp_ - cols)), constant_values=v)
    prior_batched = prior.ndim == 3
    halo = ((P, P + rp_ - rows), (P, P + cp_ - cols))
    prior_pad = jnp.pad(prior.astype(jnp.float32),
                        (((0, 0),) if prior_batched else ()) + halo)

    kern = functools.partial(
        _kernel, float(cp.resolution), float(cp.chisquare_val ** 2), rows,
        cols, P, prior_batched,
    )
    out = pl.pallas_call(
        kern,
        grid=(B, rp_ // TR, cp_ // TC),
        out_shape=jax.ShapeDtypeStruct((B, rp_, cp_), jnp.float32),
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        backend="triton",
        name="cilqr_propagate_uncertainty",
    )(jnp.asarray(radius), jnp.asarray(disc2), prior_pad,
      grow(sx, 1.0), grow(sy, 1.0), grow(rho, 0.0), grow(psd, 0.0))
    return out[:, :rows, :cols].astype(prior.dtype)
