"""Chance-constrained NMPC baseline — the reference's `CCNMPC/` algorithm.

The reference repo ships only run instructions for this baseline
(`CCNMPC/readme.md:1-36`; its implementation — a CasADi NMPC per the
environment requirements at `/root/reference/README.md:9-14` — lived outside
the snapshot).  This module provides a JAX equivalent so the
framework can run the full algorithm comparison of
`batch_dataprocess.py:459-463` (CCNMPC / CILQR / CILQR_Base / Frenet)
without external solvers.

Formulation (standard linearized chance-constraint tightening, Blackmore &
Ono style):

  1. Propagate the ego state covariance along the nominal trajectory through
     the linearized dynamics:  Sigma_{k+1} = A_k Sigma_k A_k^T + W, with W
     the per-cycle localization noise the experiment injects
     (ilqr_uncertainty_node.cpp:82-110) and A_k the analytic bicycle
     Jacobian (Model.cpp:100-127).
  2. Convert each per-timestep obstacle chance constraint
     P(ego in safety ellipse) <= delta into a deterministic constraint by
     inflating the ellipse half-axes with the kappa(delta)-sigma bound of
     the position covariance projected onto the obstacle frame.  For a 2-DOF
     Gaussian the 1-delta quantile is analytic: chi2_2^{-1}(1-delta) =
     -2 ln(delta), so kappa = sqrt(-2 ln delta) — no scipy needed, and the
     whole pipeline stays jittable.
  3. Solve the tightened OCP with the same trust-region iLQR engine the
     CILQR planner uses (exponential barriers on the tightened ellipses),
     and repeat the linearize-tighten-solve loop ``n_sqp`` times (SQP-style)
     so the covariance is propagated along the *optimized* trajectory.

Everything is fixed-shape and jittable: `run_step` matches
``solver.run_step``'s signature/result so the closed-loop plant, the
experiment runner and the batch layers drive it unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp

from cilqr_tpu.models import dynamics, obstacles as obs_mod, solver
from cilqr_tpu.utils.params import NoiseParams, SolverParams


@dataclasses.dataclass(frozen=True)
class CCParams:
    """Chance-constraint configuration."""

    delta: float = 0.05   # per-(obstacle, timestep) violation probability
    n_sqp: int = 2        # linearize-tighten-solve outer iterations

    @property
    def kappa(self) -> float:
        """sqrt(chi2_2dof quantile at 1-delta) = sqrt(-2 ln delta)."""
        return math.sqrt(-2.0 * math.log(self.delta))


def process_noise(noise: NoiseParams, dtype=jnp.float32) -> jax.Array:
    """Per-cycle localization noise as a (4, 4) state covariance increment.

    The experiment injects N(0, sigma) on x/y/theta every planning cycle
    (ilqr_uncertainty_node.cpp:82-110); speed is observed exactly.
    """
    return jnp.diag(jnp.asarray(
        [noise.sigma_x**2, noise.sigma_y**2, 0.0, noise.sigma_theta**2],
        dtype=dtype,
    ))


def propagate_covariance(
    p: SolverParams, X: jax.Array, U: jax.Array, Sigma0: jax.Array, W: jax.Array
) -> jax.Array:
    """Sigma_k along a nominal (X, U) trajectory.

    Args:
      X: (N+1, 4) nominal states;  U: (N, 2) nominal controls.
      Sigma0: (4, 4) initial state covariance;  W: (4, 4) process noise.
    Returns:
      (N+1, 4, 4) covariance stack.
    """
    # Jacobians at the *predecessor* states (standard EKF-style propagation;
    # the solver's successor-state parity quirk is irrelevant here — this is
    # new capability, not a reference-faithful path).
    fx, _ = dynamics.jacobians(p, X[:-1, 2], X[:-1, 3], U[:, 0])

    def step(S, A):
        hp = jax.lax.Precision.HIGHEST  # no TF32 on a GPU
        S1 = jnp.matmul(jnp.matmul(A, S, precision=hp), A.T, precision=hp) + W
        return S1, S1

    _, Ss = jax.lax.scan(step, Sigma0, fx)
    return jnp.concatenate([Sigma0[None], Ss], axis=0)


def tightened_obstacles(
    p: SolverParams, cc: CCParams, obstacles: obs_mod.Obstacles, Sigmas: jax.Array
) -> obs_mod.Obstacles:
    """Inflate every obstacle's per-timestep footprint by the kappa-sigma
    bound of the ego position covariance projected onto the obstacle frame.

    The obstacle cost derives half-axes a = dims[0]/2 + ..., so adding
    2 * kappa * sigma_axis to ``dims`` inflates each half-axis by
    kappa * sigma_axis.
    """
    N = obstacles.dims.shape[1]
    Sxy = Sigmas[:N, :2, :2]                      # (N, 2, 2)
    oth = obstacles.pos[..., 3]                   # (M, N)
    co, so = jnp.cos(oth), jnp.sin(oth)
    # var along the obstacle-frame major/minor axes: e^T Sigma e
    var_a = (co * co * Sxy[None, :, 0, 0]
             + 2.0 * co * so * Sxy[None, :, 0, 1]
             + so * so * Sxy[None, :, 1, 1])      # (M, N)
    var_b = (so * so * Sxy[None, :, 0, 0]
             - 2.0 * co * so * Sxy[None, :, 0, 1]
             + co * co * Sxy[None, :, 1, 1])
    grow = 2.0 * cc.kappa * jnp.stack(
        [jnp.sqrt(jnp.maximum(var_a, 0.0)), jnp.sqrt(jnp.maximum(var_b, 0.0))],
        axis=-1,
    )  # (M, N, 2)
    return obs_mod.Obstacles(obstacles.dims + grow, obstacles.pos, obstacles.mask)


def run_step(
    p: SolverParams,
    cc: CCParams,
    noise: NoiseParams,
    plan_xy: jax.Array,
    plan_n: jax.Array,
    ego_state: jax.Array,
    U_warm: jax.Array,
    obstacles: Optional[obs_mod.Obstacles] = None,
    unc_map=None,
    Sigma0: Optional[jax.Array] = None,
) -> solver.SolveResult:
    """One chance-constrained planning cycle (drop-in for solver.run_step).

    ``unc_map`` is accepted for signature compatibility and ignored — the
    CCNMPC baseline handles uncertainty through constraint tightening, not
    through the propagated costmap (that is exactly the axis the reference's
    experiments compare).
    """
    del unc_map
    dtype = ego_state.dtype
    W = process_noise(noise, dtype)
    if Sigma0 is None:
        Sigma0 = W

    if obstacles is None:
        return solver.run_step(p, plan_xy, plan_n, ego_state, U_warm, None, None)

    res = None
    U = U_warm
    for _ in range(cc.n_sqp):  # static unroll — n_sqp is tiny
        X_nom = dynamics.rollout(p, ego_state, U)
        Sig = propagate_covariance(p, X_nom, U, Sigma0, W)
        ob_t = tightened_obstacles(p, cc, obstacles, Sig)
        res = solver.run_step(p, plan_xy, plan_n, ego_state, U, ob_t, None)
        U = res.U
    return res
