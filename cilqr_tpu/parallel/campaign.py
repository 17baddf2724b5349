"""Checkpointed Monte-Carlo campaign driver: pod-scale sigma sweeps.

The reference's campaign procedure is manual — run CARLA N times while
turning the sigma knobs in rqt_reconfigure, `rosbag record` each run, then
batch-process the bags (CILQR/src/README.md, batch_dataprocess.py).  This
driver is the framework equivalent at pod scale:

  * each **round** draws ``batch`` fresh (sigma, ego-noise) scenarios
    (deterministically from the campaign key + round index), propagates each
    scenario's uncertainty costmap and solves the whole batch through the
    scenario-sharded mesh program (parallel/monte_carlo.py);
  * per-round metric sums accumulate in a tiny pytree that is
    **checkpointed** after every round (utils/checkpoint: atomic npz +
    metadata) — a preempted multi-hour run resumes at the next round with
    bit-identical results to an uninterrupted run;
  * per-round result rows stream to a host-local **experiment log shard**
    (`shard_<process>.log`, the native CRC-framed format of
    utils/explog) so multi-host runs never funnel raw trajectories across
    hosts; ``merge_analysis`` folds all shards into one metrics table.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cilqr_tpu.parallel import monte_carlo as mc
from cilqr_tpu.utils import checkpoint as ckpt
from cilqr_tpu.utils.params import CostmapParams, SolverParams


class CampaignState(NamedTuple):
    """Accumulated cross-round state (the checkpointed pytree)."""

    rounds_done: jax.Array      # () int32
    n_solves: jax.Array         # () float64-safe count
    sum_J: jax.Array            # ()
    max_J: jax.Array            # ()
    sum_iterations: jax.Array   # ()
    sum_converged: jax.Array    # ()


def _zero_state(dtype=np.float32) -> CampaignState:
    z = jnp.zeros((), dtype)
    return CampaignState(jnp.zeros((), jnp.int32), z, z, z - jnp.inf, z, z)


def run_campaign(
    p: SolverParams,
    cp: CostmapParams,
    mesh,
    prior: jax.Array,
    geom,
    origin_xy,
    origin_yaw,
    plan_xy: jax.Array,
    plan_n,
    base_ego,
    n_rounds: int,
    batch: int,
    out_dir: str,
    seed: int = 0,
    obstacles=None,
    resume: bool = True,
    log_rows: bool = True,
) -> dict:
    """Run (or resume) a checkpointed Monte-Carlo campaign.

    Returns the final merged metrics dict.  Deterministic in (seed, round):
    interrupting after any round and resuming yields the same final state.
    """
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    proc = jax.process_index()
    dtype = prior.dtype

    mc_fn, sharding = mc.make_sharded_monte_carlo(
        p, cp, mesh, obstacles=obstacles,
        map_shape=prior.shape, map_center=tuple(np.asarray(geom.center).tolist()),
    )

    state = _zero_state(dtype)
    start_round = 0
    if resume:
        last = ckpt.latest_step(str(out))
        if last is not None:
            state = ckpt.restore(str(out / f"ckpt_{last:06d}.npz"), state)
            start_round = int(state.rounds_done)

    log = None
    if log_rows:
        from cilqr_tpu.utils import explog

        mode = "a" if (resume and start_round > 0) else "w"
        log = explog.ExperimentLog(out / f"shard_{proc:03d}.log", mode)

    key = jax.random.key(seed)
    for r in range(start_round, n_rounds):
        k_r = jax.random.fold_in(key, r)
        samples = mc.sample_scenarios(k_r, batch, base_ego, dtype=dtype)
        # multi-process safe: each host contributes its own slice of the
        # (identically sampled) global batch — see multihost.put_global
        from cilqr_tpu.parallel import multihost

        res, metrics = mc_fn(
            prior, geom, jnp.asarray(origin_xy, dtype), jnp.asarray(origin_yaw, dtype),
            plan_xy, plan_n,
            multihost.put_global(sharding, samples.sigmas),
            multihost.put_global(sharding, samples.egos),
        )
        jax.block_until_ready(metrics)

        B = batch
        state = CampaignState(
            rounds_done=state.rounds_done + 1,
            n_solves=state.n_solves + B,
            sum_J=state.sum_J + metrics.mean_J * B,
            max_J=jnp.maximum(state.max_J, metrics.max_J),
            sum_iterations=state.sum_iterations + metrics.mean_iterations * B,
            sum_converged=state.sum_converged + metrics.converged_frac * B,
        )

        if log is not None:
            # one record per round: the round's metric row (X/U payload
            # slots carry the local-shard summary, not raw trajectories).
            # The logged batch is this process's SHARE of the global batch
            # (metrics are already psum-global and identical on every host)
            # so merge_analysis across shards counts each solve exactly once.
            log.append(
                start_time=float(r),
                start_pos=np.asarray(samples.egos[0]),
                planning_time=float(metrics.mean_J),
                X=np.asarray(
                    [[float(metrics.mean_J), float(metrics.max_J),
                      float(metrics.mean_iterations), float(metrics.converged_frac)]]
                ),
                U=np.asarray([[float(B // jax.process_count()), float(r)]]),
            )
            log.flush()

        if proc == 0:
            ckpt.save(str(out / f"ckpt_{r:06d}.npz"), state)
            ckpt.save_metadata(
                str(out / "campaign.json"),
                {"rounds_done": r + 1, "batch": batch, "seed": seed,
                 "n_rounds": n_rounds},
            )

    if log is not None:
        log.close()
    return summarize(state)


def summarize(state: CampaignState) -> dict:
    n = float(np.maximum(np.asarray(state.n_solves), 1.0))
    return {
        "rounds": int(state.rounds_done),
        "solves": int(np.asarray(state.n_solves)),
        "mean_J": float(np.asarray(state.sum_J)) / n,
        "max_J": float(np.asarray(state.max_J)),
        "mean_iterations": float(np.asarray(state.sum_iterations)) / n,
        "converged_frac": float(np.asarray(state.sum_converged)) / n,
    }


def merge_analysis(out_dir: str) -> dict:
    """Fold every host's explog shard into one campaign metrics table."""
    from cilqr_tpu.utils import explog

    rows = []
    for shard in sorted(pathlib.Path(out_dir).glob("shard_*.log")):
        data = explog.read_experiment_log(str(shard))
        # per-round X: (1, 4) [mean_J, max_J, iters, conv]; U: (1, 2) [batch, round]
        for X, U in zip(data["X"], data["U"]):
            rows.append({
                "shard": shard.name,
                "round": int(U[0, 1]),
                "batch": int(U[0, 0]),
                "mean_J": float(X[0, 0]),
                "max_J": float(X[0, 1]),
                "mean_iterations": float(X[0, 2]),
                "converged_frac": float(X[0, 3]),
            })
    if not rows:
        return {"rounds": 0, "rows": []}
    w = np.asarray([r["batch"] for r in rows], np.float64)
    return {
        "rounds": len(rows),
        "solves": int(w.sum()),
        "mean_J": float(np.average([r["mean_J"] for r in rows], weights=w)),
        "max_J": float(np.max([r["max_J"] for r in rows])),
        "converged_frac": float(
            np.average([r["converged_frac"] for r in rows], weights=w)),
        "rows": rows,
    }
