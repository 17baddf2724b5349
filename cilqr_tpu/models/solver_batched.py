"""Batch-level CILQR solver: one (B, ...) scenario batch per call.

``run_steps_batched`` solves every lane with the semantics of
``solver.run_step`` (same quirks, same masked convergence).  It has two
routes and picks one from the backend and the input, never from a flag:

* the XLA route, ``batched_optimize`` — the LM ``while_loop`` at batch level
  with per-lane masks around the vmapped ``costs.all_cost_derivs_and_J``,
  ``solver.backward_from_derivs`` and ``solver.forward_pass``.  It runs on
  every backend and carries every kind of world: shared, per-scenario
  uncertainty maps, per-scenario obstacles;
* the fused GPU kernel, ``ops.lm_pallas.fused_optimize`` — the whole LM loop
  in one launch per block of lanes.  It takes float32 batches with shared
  obstacles and a shared or per-scenario uncertainty map.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cilqr_tpu.models import costs as costs_mod, dynamics, solver
from cilqr_tpu.models.reference_path import get_local_plan
from cilqr_tpu.utils.params import SolverParams


def batched_optimize(
    p: SolverParams,
    plans,
    x0s: jax.Array,
    U_init: jax.Array,
    obstacles=None,
    unc_map=None,
):
    """LM loop (iLQR.cpp:201-245) over a (B, ...) scenario batch on XLA.

    plans: vmapped LocalPlan pytree (leading axis B).  ``obstacles`` /
    ``unc_map`` are shared, or carry a leading B axis (one world per
    scenario: ``obstacles.pos`` of rank 4, ``unc_map.values`` of rank 3).
    Per-scenario maps are sampled with plain gathers instead of the one-hot
    contraction (see ``uncertainty.uncertainty_cost``'s use_onehot note).
    Returns (X (B,N+1,4), U (B,N,2), iters (B,), J (B,), lamb (B,),
    failed (B,)); ``failed`` as in ``solver.optimize``."""
    B = x0s.shape[0]
    dtype = x0s.dtype
    X0 = jax.vmap(lambda e, u: dynamics.rollout(p, e, u))(x0s, U_init)
    big = jnp.full((B,), jnp.finfo(dtype).max, dtype)

    ob_ax = 0 if obstacles is not None and obstacles.pos.ndim == 4 else None
    um_ax = 0 if unc_map is not None and unc_map.values.ndim == 3 else None
    inner = jax.vmap(
        lambda pl_, Xi, Ui, ob, um: costs_mod.all_cost_derivs_and_J(
            p, pl_, Xi, Ui, ob, um, unc_onehot=um_ax is None
        ),
        in_axes=(0, 0, 0, ob_ax, um_ax),
    )
    backward = jax.vmap(
        lambda d, Xi, Ui, li: solver.backward_from_derivs(p, d, Xi, Ui, li))
    forward = jax.vmap(
        lambda Xi, Ui, ki, Ki: solver.forward_pass(p, Xi, Ui, ki, Ki))

    def cond(carry):
        X, U, J_old, lamb, it, done, failed = carry
        return jnp.any(jnp.logical_and(~done, it < p.max_iterations))

    def body(carry):
        X, U, J_old, lamb, it, done, failed = carry
        d, J_new = inner(plans, X, U, obstacles, unc_map)
        k, K = backward(d, X, U, lamb)
        X_new, U_new = forward(X, U, k, K)

        # failed backward pass: stop, keep X/U/lambda (solver.optimize)
        ok = (jnp.all(jnp.isfinite(k), axis=(1, 2))
              & jnp.all(jnp.isfinite(K), axis=(1, 2, 3)))
        accept = (J_new < J_old) & ok
        X_n = jnp.where(accept[:, None, None], X_new, X)
        U_n = jnp.where(accept[:, None, None], U_new, U)
        lamb_n = jnp.where(
            ok, jnp.where(accept, lamb / p.lamb_factor, lamb * p.lamb_factor), lamb)
        stop = ~ok | jnp.where(
            accept, jnp.abs(J_new - J_old) < p.tolerance, lamb_n > p.lamb_max
        )
        X_o = jnp.where(done[:, None, None], X, X_n)
        U_o = jnp.where(done[:, None, None], U, U_n)
        J_o = jnp.where(done, J_old, J_new)
        lamb_o = jnp.where(done, lamb, lamb_n)
        it_o = jnp.where(done, it, it + 1)
        failed_o = jnp.where(done, failed, ~ok)
        return (X_o, U_o, J_o, lamb_o, it_o, done | stop, failed_o)

    carry0 = (
        X0,
        U_init,
        big,
        jnp.full((B,), p.lamb_init, dtype),
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), bool),
        jnp.zeros((B,), bool),
    )
    X, U, J, lamb, it, _, failed = jax.lax.while_loop(cond, body, carry0)
    return X, U, it, J, lamb, failed


def kernel_route(x0s: jax.Array, obstacles=None) -> bool:
    """True when ``run_steps_batched`` takes the fused GPU kernel: on a GPU
    backend, for float32 batches whose obstacles (if any) are shared."""
    if jax.default_backend() != "gpu" or x0s.dtype != jnp.float32:
        return False
    return obstacles is None or obstacles.pos.ndim == 3


def run_steps_batched(
    p: SolverParams,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    egos: jax.Array,
    U_warm: jax.Array,
    obstacles=None,
    unc_map=None,
) -> solver.SolveResult:
    """Batched ``run_step`` (iLQR.cpp:247-255) for any batch size B.

    ``obstacles`` / ``unc_map`` are shared or per-scenario (leading B axis),
    as in ``batched_optimize``.  The route (XLA or the fused GPU kernel) is
    chosen by ``kernel_route`` from the backend and the input."""
    plans = jax.vmap(lambda e: get_local_plan(p, plan_xy, plan_n, e))(egos)
    if kernel_route(egos, obstacles):
        from cilqr_tpu.ops import lm_pallas

        X, U, it, J, lamb, failed = lm_pallas.fused_optimize(
            p, plans, egos, U_warm, obstacles, unc_map
        )
    else:
        X, U, it, J, lamb, failed = batched_optimize(
            p, plans, egos, U_warm, obstacles, unc_map
        )
    return solver.SolveResult(X, U, plans.x_wpts, plans.y_fit, it, J, lamb, failed)


@partial(jax.jit, static_argnums=0)
def run_steps_batched_jit(p, plan_xy, plan_n, egos, U_warm, obstacles=None,
                          unc_map=None):
    return run_steps_batched(p, plan_xy, plan_n, egos, U_warm, obstacles,
                             unc_map)
