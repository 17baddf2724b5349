"""Scenario batching & device-mesh sharding — the P8 axis.

The reference has no ML-style parallelism to port (SURVEY.md §2.5): its
"distributed backend" is five ROS processes on TCP.  The scaling axis here
is *scenarios*: the whole solve is a pure function, so

  * on-device batching = ``vmap`` / ``solver_batched`` (one (B, ...) program)
  * multi-device       = ``shard_map`` over a 1-D ``Mesh`` on the batch axis,
    with plan/costmap replicated and per-scenario metrics reduced via
    ``psum`` — the only collective; the scatter and gather move inputs and
    results (jax.make_array_from_process_local_data on multi-host).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cilqr_tpu.models import solver
from cilqr_tpu.utils.params import SolverParams

BATCH_AXIS = "scenarios"


class BatchMetrics(NamedTuple):
    """Global (cross-chip) reductions of per-scenario results."""

    mean_J: jax.Array
    max_J: jax.Array
    mean_iterations: jax.Array
    # stopped early on |dJ| < tol (excludes lambda-abort lanes; a lane whose
    # tolerance stop lands exactly on the max_iterations-th iteration is
    # indistinguishable from exhaustion and counts as unconverged)
    converged_frac: jax.Array


def make_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (BATCH_AXIS,))


def batched_solve(p: SolverParams, plan_xy, plan_n, egos, U_warm, obstacles=None, unc_map=None):
    """vmap over the scenario axis of (egos (B,4), U_warm (B,N,2)).

    plan/obstacles/uncertainty map are shared (broadcast) across the batch —
    the common Monte-Carlo setting (one world, many sampled initial states);
    for fully heterogeneous scenarios vmap the caller's own axes instead.
    """
    fn = lambda e, u: solver.run_step(p, plan_xy, plan_n, e, u, obstacles, unc_map)
    return jax.vmap(fn)(egos, U_warm)


def _metrics_local(p: SolverParams, res: solver.SolveResult, axis: Optional[str]) -> BatchMetrics:
    B = res.J.shape[0]
    # early stop + lambda still in range <=> tolerance convergence; a
    # lambda-abort lane (iLQR.cpp:233-236) ends with lamb > lamb_max, a
    # failed backward pass (iLQR.cpp:159-162) with ``failed``
    conv = (
        (res.iterations < p.max_iterations) & (res.lamb <= p.lamb_max)
        & ~res.failed
    ).astype(res.J.dtype)
    sums = jnp.stack([
        jnp.sum(res.J),
        jnp.sum(res.iterations.astype(res.J.dtype)),
        jnp.sum(conv),
        jnp.asarray(B, res.J.dtype),
    ])
    mx = jnp.max(res.J)
    if axis is not None:
        sums = jax.lax.psum(sums, axis)
        mx = jax.lax.pmax(mx, axis)
    n = sums[3]
    return BatchMetrics(sums[0] / n, mx, sums[1] / n, sums[2] / n)


def solve_and_reduce(p: SolverParams, plan_xy, plan_n, egos, U_warm,
                     obstacles=None, unc_map=None, axis: Optional[str] = None):
    res = batched_solve(p, plan_xy, plan_n, egos, U_warm, obstacles, unc_map)
    return res, _metrics_local(p, res, axis)


def make_sharded_solver(p: SolverParams, mesh: Mesh, obstacles=None, unc_map=None):
    """Build a jitted multi-device solver: scenario axis sharded over the
    mesh, everything else replicated, metrics reduced with one collective.

    Each shard runs ``solver_batched.run_steps_batched``, which picks its
    route (XLA or the GPU kernel) from the backend and the shard's input.

    Returns ``fn(plan_xy, plan_n, egos, U_warm) -> (SolveResult, BatchMetrics)``
    with ``egos/U_warm`` sharded on their leading axis and the result
    likewise (metrics fully replicated).
    """
    n_dev = mesh.devices.size
    batch_spec = P(BATCH_AXIS)
    repl = P()

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(repl, repl, batch_spec, batch_spec),
        out_specs=(batch_spec, repl),
        check_vma=False,
    )
    def shard_fn(plan_xy, plan_n, egos, U_warm):
        from cilqr_tpu.models import solver_batched

        res = solver_batched.run_steps_batched(
            p, plan_xy, plan_n, egos, U_warm, obstacles, unc_map
        )
        return res, _metrics_local(p, res, BATCH_AXIS)

    def fn(plan_xy, plan_n, egos, U_warm):
        if egos.shape[0] % n_dev:
            raise ValueError(f"batch {egos.shape[0]} not divisible by mesh size {n_dev}")
        return shard_fn(plan_xy, plan_n, egos, U_warm)

    return jax.jit(fn), NamedSharding(mesh, P(BATCH_AXIS))


def make_sharded_full_stack(
    p: SolverParams,
    cp,
    mesh: Mesh,
    n_cycles: int,
    obstacles=None,
    obs_xyyaw=None,
    obs_size=None,
    obs_mask=None,
    band_plan=None,
    percept=None,
):
    """Scenario-sharded COMPLETE pipeline: per-cycle per-scenario costmap
    rebuild (batched propagation + prior resample) feeding the batched
    solver, with the perception channel optionally on — i.e.
    ``plant.closed_loop_full_stack_batched`` per shard.  World inputs
    (global map, route) are replicated; only the scenario axis is sharded,
    so the only collective is one psum for the summary metrics — everything
    else stays on its own device.

    Returns ``fn(global_map, global_geom, plan_xy, plan_n, x0s, key) ->
    (final_states sharded, record sharded, summary replicated)`` where
    ``summary`` is (mean_J, collision_frac) psum-reduced across the mesh.
    Each shard folds its mesh position into the key so scenario noise
    streams differ across shards.
    """
    n_dev = mesh.devices.size
    batch_spec = P(BATCH_AXIS)
    repl = P()

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(repl, repl, repl, repl, batch_spec, repl),
        # record leaves are (n_cycles, B, ...): scenario axis is axis 1
        out_specs=(batch_spec, P(None, BATCH_AXIS), repl),
        check_vma=False,
    )
    def shard_fn(global_map, global_geom, plan_xy, plan_n, x0s, key):
        from cilqr_tpu.sim import plant
        from cilqr_tpu.utils.params import NoiseParams

        key = jax.random.fold_in(key, jax.lax.axis_index(BATCH_AXIS))
        xf, rec = plant.closed_loop_full_stack_batched(
            p, cp, NoiseParams(), global_map, global_geom, plan_xy, plan_n,
            x0s, key, n_cycles, obstacles=obstacles,
            obs_xyyaw=obs_xyyaw, obs_size=obs_size, obs_mask=obs_mask,
            band_plan=band_plan, percept=percept,
        )
        Bl = x0s.shape[0]
        sums = jax.lax.psum(
            jnp.stack([
                jnp.sum(rec["J"][-1]),
                jnp.sum(rec["collided"].any(axis=0).astype(rec["J"].dtype)),
                jnp.asarray(Bl, rec["J"].dtype),
            ]),
            BATCH_AXIS,
        )
        summary = (sums[0] / sums[2], sums[1] / sums[2])
        return xf, rec, summary

    def fn(global_map, global_geom, plan_xy, plan_n, x0s, key):
        if x0s.shape[0] % n_dev:
            raise ValueError(
                f"batch {x0s.shape[0]} not divisible by mesh size {n_dev}")
        return shard_fn(global_map, global_geom, plan_xy, plan_n, x0s, key)

    return jax.jit(fn), NamedSharding(mesh, P(BATCH_AXIS))
