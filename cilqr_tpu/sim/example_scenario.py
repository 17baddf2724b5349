"""Canonical example scenario used by the benchmark and driver entry
points: a curving CARLA-scale lane, two static obstacles, and a random
uncertainty costmap."""

from __future__ import annotations

import numpy as np


def example_scenario(p, dtype):
    import jax.numpy as jnp

    from cilqr_tpu.models import obstacles as obs_mod
    from cilqr_tpu.models import reference_path as rp
    from cilqr_tpu.models import solver, uncertainty as unc_mod

    n_pts = min(120, p.max_global_plan_points)
    s = np.linspace(0.0, 119.0, n_pts)
    plan_np = np.stack(
        [90.0 + s, -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s], axis=1
    )
    plan, n = rp.pad_global_plan(p, plan_np, dtype=dtype)
    ego = jnp.asarray([100.0, -305.6, 4.0, 0.05], dtype)
    U0 = solver.initial_controls(p, dtype=dtype)
    obstacles = obs_mod.make_static_obstacles(
        p, [[115.0, -305.0], [130.0, -304.0]], [[3.63, 1.84]] * 2, [0.0, 0.2], dtype=dtype
    )
    rng = np.random.default_rng(0)
    unc = unc_mod.make_uncertainty_map(
        rng.uniform(0.0, 100.0, (48, 32)),
        [10.0, 0.0],
        0.2,
        np.asarray(ego[:2]),
        float(ego[3]),
        dtype=dtype,
    )
    return plan, n, ego, U0, obstacles, unc


def example_global_map(dtype, seed: int = 0):
    """The full-stack benchmark's global prior: a 256 x 256 occupancy map
    (uniform in [0, 100]) at 0.5 m covering the example lane.  Returns
    (global_map, global_geom)."""
    import jax.numpy as jnp

    from cilqr_tpu.ops import gridmap

    gmap = np.random.default_rng(seed).uniform(0.0, 100.0, (256, 256))
    geom = gridmap.make_geom([110.0, -300.0], 0.5, 256, 256, dtype=dtype)
    return jnp.asarray(gmap, dtype), geom
