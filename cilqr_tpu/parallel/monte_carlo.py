"""Monte-Carlo uncertainty-aware CILQR: sampled covariances at pod scale.

BASELINE.json configs 3 and 5:

  (3) uncertainty-aware CILQR with *sampled* covariances — each scenario
      draws its own localization sigma (sigma_x, sigma_y, sigma_theta) and
      ego-pose noise, propagates its own uncertainty costmap, and solves.
  (5) 16k-scenario Monte-Carlo with the costmap transformation sharded over
      a device mesh: the scenario axis is the only sharded axis, so the
      propagation + solve graph is fully replicated per device and the only
      collective is the psum metric reduction; across hosts only the
      initial scatter / final gather move data
      (see cilqr_tpu/parallel/multihost.py).

The reference analog is running the CARLA experiment N times while turning
the sigma knobs in rqt_reconfigure (map_engine.cfg) — here one device
program evaluates thousands of sigma draws in parallel.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cilqr_tpu.models import reference_path as rp
from cilqr_tpu.models import solver, uncertainty as unc_mod
from cilqr_tpu.ops import costmap as costmap_mod
from cilqr_tpu.parallel.batch import BATCH_AXIS, _metrics_local
from cilqr_tpu.sim import plant
from cilqr_tpu.utils.params import CostmapParams, NoiseParams, SolverParams


class MCSample(NamedTuple):
    sigmas: jax.Array     # (B, 3) sampled (sigma_x, sigma_y, sigma_theta)
    egos: jax.Array       # (B, 4) noisy initial states


DEFAULT_SIGMA_LO = (0.02, 0.02, 0.005)
DEFAULT_SIGMA_HI = (0.25, 0.25, 0.05)


def ensure_window_covers(cp: CostmapParams, rows: int, cols: int, center,
                         sigma_hi=DEFAULT_SIGMA_HI) -> CostmapParams:
    """Return ``cp`` with ``window_radius`` enlarged (if needed) to cover the
    95% ellipse of the *largest* sampled covariance — sampled sigmas beyond
    the configured window would silently truncate the footprint and break
    the EllipseIterator-exact semantics."""
    import dataclasses

    need = costmap_mod.required_window_radius(
        cp, rows, cols, center=(float(center[0]), float(center[1])), sigmas=sigma_hi
    )
    if need > cp.window_radius:
        return dataclasses.replace(cp, window_radius=need)
    return cp


def sample_scenarios(
    key: jax.Array,
    n: int,
    base_ego,
    sigma_lo=DEFAULT_SIGMA_LO,
    sigma_hi=DEFAULT_SIGMA_HI,
    dtype=jnp.float32,
) -> MCSample:
    """Draw per-scenario covariances (uniform in range) and ego noise
    (N(0, sigma) per the drawn sigma — the noise-injection feature of
    ilqr_uncertainty_node.cpp:82-110 with randomized magnitude)."""
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, (n, 3), dtype=dtype)
    lo = jnp.asarray(sigma_lo, dtype)
    hi = jnp.asarray(sigma_hi, dtype)
    sigmas = lo + u * (hi - lo)
    r = jax.random.normal(k2, (n, 3), dtype=dtype)
    base = jnp.asarray(base_ego, dtype)
    egos = jnp.broadcast_to(base, (n, 4))
    egos = egos.at[:, 0].add(sigmas[:, 0] * r[:, 0])
    egos = egos.at[:, 1].add(sigmas[:, 1] * r[:, 1])
    egos = egos.at[:, 3].add(sigmas[:, 2] * r[:, 2])
    return MCSample(sigmas, egos)


def mc_solve_one(
    p: SolverParams,
    cp: CostmapParams,
    prior: jax.Array,
    geom,
    origin_xy: jax.Array,
    origin_yaw: jax.Array,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    sigmas: jax.Array,
    ego: jax.Array,
    U0: jax.Array,
    obstacles=None,
) -> solver.SolveResult:
    """One scenario: propagate the uncertainty costmap under the sampled
    covariance, then solve with the uncertainty barrier."""
    unc_vals = costmap_mod.propagate_uncertainty_reference(
        cp, prior, geom, origin_yaw, sigmas=(sigmas[0], sigmas[1], sigmas[2])
    )
    umap = unc_mod.UncertaintyMap(unc_vals, geom, origin_xy, origin_yaw)
    return solver.run_step(p, plan_xy, plan_n, ego, U0, obstacles, umap)


def monte_carlo_reference(
    p: SolverParams,
    cp: CostmapParams,
    prior: jax.Array,
    geom,
    origin_xy,
    origin_yaw,
    plan_xy,
    plan_n,
    samples: MCSample,
    obstacles=None,
):
    """The semantics oracle of ``monte_carlo``: vmap of ``mc_solve_one``
    (float64 propagation and solve when the inputs are float64)."""
    U0 = solver.initial_controls(p, dtype=samples.egos.dtype)
    fn = lambda s, e: mc_solve_one(
        p, cp, prior, geom, origin_xy, origin_yaw, plan_xy, plan_n, s, e,
        U0, obstacles
    )
    return jax.vmap(fn)(samples.sigmas, samples.egos)


def monte_carlo(
    p: SolverParams,
    cp: CostmapParams,
    prior: jax.Array,
    geom,
    origin_xy,
    origin_yaw,
    plan_xy,
    plan_n,
    samples: MCSample,
    obstacles=None,
    sigma_hi=DEFAULT_SIGMA_HI,
    band_plan=None,
):
    """Config-3 batch on one device: per-scenario costmap + solve.

    The batched propagation (``costmap.propagate_uncertainty_batched``)
    gives every scenario its own map under its sampled covariance; the
    batched solver (``solver_batched.run_steps_batched``) then plans every
    scenario against its own map.  Each picks its route (XLA or GPU
    kernel) from the backend and the input.

    band_plan: optional static row-band plan from
    ``costmap.make_band_plan`` (built OUTSIDE jit with the same sigma_hi
    bound) — the GPU kernel's per-band windows.

    ``sigma_hi`` must bound the sampled sigmas: the propagation window is
    auto-enlarged to cover its 95% ellipse (see ensure_window_covers).
    Under jit the map center is traced and the check must happen at build
    time instead — pre-size ``cp`` via ``ensure_window_covers`` (as
    ``make_sharded_monte_carlo`` does)."""
    try:
        cp = ensure_window_covers(
            cp, prior.shape[0], prior.shape[1],
            (float(geom.center[0]), float(geom.center[1])), sigma_hi,
        )
    except (TypeError, jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError):
        pass  # traced center: caller pre-sized cp
    B = samples.egos.shape[0]
    U0 = solver.initial_controls(p, dtype=samples.egos.dtype)

    from cilqr_tpu.models import solver_batched

    if band_plan is not None:
        plan_hi = getattr(band_plan, "sigma_hi", None)
        if plan_hi is not None and any(
            ph < h for ph, h in zip(plan_hi, sigma_hi)
        ):
            raise ValueError(
                f"band_plan covers sigma_hi={plan_hi} but sampling bound is "
                f"{tuple(sigma_hi)} — rebuild the plan with the larger bound "
                "(a too-small band radius silently truncates the 95% ellipse)"
            )
    unc_vals = costmap_mod.propagate_uncertainty_batched(
        cp, prior, geom, origin_yaw, samples.sigmas, band_plan
    )
    bc = lambda a: jnp.broadcast_to(
        jnp.asarray(a), (B,) + jnp.shape(jnp.asarray(a))
    )
    umaps = unc_mod.UncertaintyMap(
        unc_vals, jax.tree.map(bc, geom), bc(origin_xy), bc(origin_yaw)
    )
    U0s = jnp.broadcast_to(U0, (B,) + U0.shape)
    return solver_batched.run_steps_batched(
        p, plan_xy, plan_n, samples.egos, U0s, obstacles, umaps,
    )


def make_sharded_monte_carlo(
    p: SolverParams,
    cp: CostmapParams,
    mesh: Mesh,
    obstacles=None,
    map_shape=None,
    map_center=None,
    sigma_hi=DEFAULT_SIGMA_HI,
):
    """Config-5 builder: scenario-sharded Monte-Carlo with per-scenario
    costmap propagation, psum metrics.  Returns (jitted fn, batch sharding).

    Pass ``map_shape=(rows, cols)`` and ``map_center=(x, y)`` so the
    propagation window is sized for the sampling bound ``sigma_hi`` at build
    time (inside the jitted shard the center is traced and cannot be
    checked).

    fn(prior, geom, origin_xy, origin_yaw, plan_xy, plan_n, sigmas, egos)
      -> (SolveResult sharded on axis 0, BatchMetrics replicated)
    """
    band_plan = None
    if map_shape is not None and map_center is not None:
        cp = ensure_window_covers(cp, map_shape[0], map_shape[1], map_center, sigma_hi)
        band_plan = costmap_mod.make_band_plan(
            cp, map_shape[0], map_shape[1], map_center, sigma_hi
        )
    batch_spec = P(BATCH_AXIS)
    repl = P()

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(repl, repl, repl, repl, repl, repl, batch_spec, batch_spec),
        out_specs=(batch_spec, repl),
        check_vma=False,
    )
    def shard_fn(prior, geom, origin_xy, origin_yaw, plan_xy, plan_n, sigmas, egos):
        res = monte_carlo(
            p, cp, prior, geom, origin_xy, origin_yaw, plan_xy, plan_n,
            MCSample(sigmas, egos), obstacles, sigma_hi=sigma_hi,
            band_plan=band_plan,
        )
        return res, _metrics_local(p, res, BATCH_AXIS)

    return jax.jit(shard_fn), NamedSharding(mesh, P(BATCH_AXIS))
