"""CILQR solver core — the JAX equivalent of class ``iLQR``.

Reference semantics: ``CILQR/src/ilqr/include/ilqr/iLQR.cpp``.  Every
documented quirk of the C++ driver is reproduced deliberately (and locked by
parity tests against the float64 NumPy oracle):

* Jacobians are evaluated at the *successor* states X[1:] with accelerations
  from U (iLQR.cpp:102-106).
* V_x/V_xx are seeded from the running cost at step N-1, which then enters
  the recursion again at j = N-1 (iLQR.cpp:108-113,133).
* Q_uu is regularized by eigenvalue clamp + lambda shift (iLQR.cpp:155-175)
  through the closed-form 2x2 path in ``ops.eig2x2``.
* V_x = Q_x - K^T Q_uu k and V_xx = Q_xx - K^T Q_uu K (iLQR.cpp:180-181) —
  the reference's (non-standard) value update.
* The forward pass is a single rollout U + k + K (X_new - X) with *no* alpha
  line search (iLQR.cpp:68-86).
* The acceptance cost J is evaluated on the *pre-update* trajectory (X, U) —
  not (X_new, U_new) — and excludes all barrier terms
  (iLQR.cpp:217, Constraints.cpp:534-561).
* lambda starts at 1, /10 on accept, x10 on reject, abort above 1e4; accept
  + |dJ| < tol terminates (iLQR.cpp:211-239).
* A failed backward pass ends the solve with the current trajectory kept
  (the eigensolver-failure abort, iLQR.cpp:159-162 and :213-215): here,
  non-finite gains, which float32 reaches when barrier Hessians overflow
  the value recursion.

The whole solve is one jitted pure function of fixed-shape inputs, so
batching across scenarios is a plain ``vmap`` and sharding a ``shard_map``
(see ``cilqr_tpu.parallel``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cilqr_tpu.models import costs as costs_mod
from cilqr_tpu.models import dynamics
from cilqr_tpu.models.reference_path import LocalPlan, get_local_plan
from cilqr_tpu.ops.eig2x2 import regularized_inverse
from cilqr_tpu.utils.params import SolverParams


class SolveResult(NamedTuple):
    X: jax.Array          # (N+1, 4) optimal state trajectory
    U: jax.Array          # (N, 2) optimal control sequence
    ref_x: jax.Array      # (num_of_local_wpts,) local plan x
    ref_y: jax.Array      # (num_of_local_wpts,) local plan fitted y
    iterations: jax.Array  # () LM iterations executed
    J: jax.Array          # () final acceptance cost
    lamb: jax.Array       # () final LM damping
    failed: jax.Array     # () stopped on a failed backward pass (non-finite gains)


def initial_controls(p: SolverParams, dtype=jnp.float32) -> jax.Array:
    """Cold-start control guess (iLQR.cpp:9-15): a = 0.5 everywhere;
    yaw-rate 0 for the first N/2 steps then 0.1."""
    N = p.horizon
    acc = jnp.full((N,), 0.5, dtype=dtype)
    yr = jnp.where(jnp.arange(N) < N // 2, 0.0, 0.1).astype(dtype)
    return jnp.stack([acc, yr], axis=-1)


def backward_pass(
    p: SolverParams,
    plan: LocalPlan,
    X: jax.Array,
    U: jax.Array,
    lamb: jax.Array,
    obstacles=None,
    unc_map=None,
):
    """Riccati/DDP backward recursion -> (k (N,2), K (N,2,4)).

    One reverse ``lax.scan`` over per-step stacks (iLQR.cpp:91-195)."""
    d = costs_mod.all_cost_derivs(p, plan, X, U, obstacles, unc_map)
    return backward_from_derivs(p, d, X, U, lamb)


def backward_from_derivs(p: SolverParams, d, X: jax.Array, U: jax.Array, lamb: jax.Array):
    """Backward recursion from precomputed cost derivatives.

    Runs under HIGHEST matmul precision: the 4x4/2x4 contractions are tiny,
    but under vmap they batch into matrix products whose default precision
    (TF32 on a GPU) costs ~3 significant digits in
    the gains.

    ``p.backward_impl='pscan'`` swaps in the O(log N)-depth associative-scan
    pass (ops/riccati_pscan.py) for the B=1 latency case."""
    with jax.default_matmul_precision("highest"):
        if p.backward_impl == "pscan":
            from cilqr_tpu.ops import riccati_pscan

            return riccati_pscan.backward_pscan(p, d, X, U, lamb)
        return _backward_from_derivs(p, d, X, U, lamb)


def _backward_from_derivs(p: SolverParams, d, X: jax.Array, U: jax.Array, lamb: jax.Array):
    N = p.horizon
    # parity quirk: jacobians at successor states (iLQR.cpp:102-106)
    fx, fu = dynamics.jacobians(p, X[1:, 2], X[1:, 3], U[:, 0])

    V_x0 = d.l_x[N - 1]
    V_xx0 = d.l_xx[N - 1]

    def step(carry, inp):
        V_x, V_xx = carry
        l_x, l_xx, l_u, l_uu, fx_j, fu_j = inp
        Q_x = l_x + fx_j.T @ V_x
        Q_u = l_u + fu_j.T @ V_x
        Q_xx = l_xx + fx_j.T @ V_xx @ fx_j
        Q_ux = fu_j.T @ V_xx @ fx_j  # l_ux == 0 (Constraints.cpp:501-506)
        Q_uu = l_uu + fu_j.T @ V_xx @ fu_j

        Q_uu_inv = regularized_inverse(Q_uu, lamb)
        k_j = -Q_uu_inv @ Q_u
        K_j = -Q_uu_inv @ Q_ux

        V_x_n = Q_x - K_j.T @ (Q_uu @ k_j)
        V_xx_n = Q_xx - K_j.T @ (Q_uu @ K_j)
        return (V_x_n, V_xx_n), (k_j, K_j)

    inputs = (d.l_x, d.l_xx, d.l_u, d.l_uu, fx, fu)
    (_, _), (k_rev, K_rev) = jax.lax.scan(
        step,
        (V_x0, V_xx0),
        jax.tree.map(lambda a: a[::-1], inputs),
        unroll=p.scan_unroll,
    )
    return k_rev[::-1], K_rev[::-1]


def forward_pass(p: SolverParams, X: jax.Array, U: jax.Array, k: jax.Array, K: jax.Array):
    """Closed-loop rollout U_new = U + k + K (X_new - X) (iLQR.cpp:68-86).

    HIGHEST matmul precision for the (2,4) gain application — see
    ``backward_from_derivs``."""

    def step(x, inp):
        X_i, U_i, k_i, K_i = inp
        u = U_i + k_i + jnp.matmul(
            K_i, x - X_i, precision=jax.lax.Precision.HIGHEST
        )
        xn = dynamics.step(p, x, u)
        return xn, (xn, u)

    _, (Xs, U_new) = jax.lax.scan(step, X[0], (X[:-1], U, k, K), unroll=p.scan_unroll)
    X_new = jnp.concatenate([X[:1], Xs], axis=0)
    return X_new, U_new


def optimize(
    p: SolverParams,
    plan: LocalPlan,
    x0: jax.Array,
    U_init: jax.Array,
    obstacles=None,
    unc_map=None,
):
    """Levenberg–Marquardt outer loop (iLQR.cpp:201-245).

    Returns (X, U, iterations, J, lamb, failed).  Implemented as a
    ``lax.while_loop`` whose carry masks finished lanes, so it early-exits
    when jitted alone and stays correct (per-scenario convergence) under
    ``vmap``.  ``failed`` marks a solve that stopped on non-finite gains.
    """
    dtype = x0.dtype
    X0 = dynamics.rollout(p, x0, U_init)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    def cond(carry):
        X, U, J_old, lamb, it, done, failed = carry
        return jnp.logical_and(jnp.logical_not(done), it < p.max_iterations)

    def body(carry):
        X, U, J_old, lamb, it, done, failed = carry
        # fused: one closest-point pass feeds both the derivatives and the
        # acceptance cost J of the pre-update trajectory (iLQR.cpp:213,217)
        d, J_new = costs_mod.all_cost_derivs_and_J(p, plan, X, U, obstacles, unc_map)
        k, K = backward_from_derivs(p, d, X, U, lamb)
        X_new, U_new = forward_pass(p, X, U, k, K)

        # failed backward pass: stop, keep X/U/lambda (iLQR.cpp:159-162)
        ok = jnp.all(jnp.isfinite(k)) & jnp.all(jnp.isfinite(K))
        accept = (J_new < J_old) & ok
        X_n = jnp.where(accept, X_new, X)
        U_n = jnp.where(accept, U_new, U)
        lamb_n = jnp.where(
            ok, jnp.where(accept, lamb / p.lamb_factor, lamb * p.lamb_factor), lamb)
        stop = ~ok | jnp.where(
            accept,
            jnp.abs(J_new - J_old) < p.tolerance,
            lamb_n > p.lamb_max,
        )
        # masked update for lanes already done (no-op under plain jit)
        X_o = jnp.where(done, X, X_n)
        U_o = jnp.where(done, U, U_n)
        J_o = jnp.where(done, J_old, J_new)
        lamb_o = jnp.where(done, lamb, lamb_n)
        it_o = jnp.where(done, it, it + 1)
        failed_o = jnp.where(done, failed, ~ok)
        return (X_o, U_o, J_o, lamb_o, it_o, jnp.logical_or(done, stop), failed_o)

    carry0 = (
        X0,
        U_init,
        big,
        jnp.asarray(p.lamb_init, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
    )
    X, U, J, lamb, it, _, failed = jax.lax.while_loop(cond, body, carry0)
    return X, U, it, J, lamb, failed


def run_step(
    p: SolverParams,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    ego_state: jax.Array,
    U_warm: jax.Array,
    obstacles=None,
    unc_map=None,
) -> SolveResult:
    """One receding-horizon planning cycle (iLQR.cpp:247-255).

    Args:
      plan_xy: (P, 2) padded global plan; plan_n: () valid count.
      ego_state: (4,) current [x, y, v, theta] (noise already injected by the
        caller, as in ilqr_uncertainty_node.cpp:110-119).
      U_warm: (N, 2) warm-start control sequence — the carried ``control_seq``
        (iLQR.cpp:9,253).  Feed ``SolveResult.U`` back in next cycle.
    """
    plan = get_local_plan(p, plan_xy, plan_n, ego_state)
    X, U, it, J, lamb, failed = optimize(p, plan, ego_state, U_warm, obstacles, unc_map)
    return SolveResult(X, U, plan.x_wpts, plan.y_fit, it, J, lamb, failed)


@partial(jax.jit, static_argnums=0)
def run_step_jit(p: SolverParams, plan_xy, plan_n, ego_state, U_warm, obstacles=None, unc_map=None):
    return run_step(p, plan_xy, plan_n, ego_state, U_warm, obstacles, unc_map)
