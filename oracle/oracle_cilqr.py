"""Float64 NumPy oracle: a faithful re-implementation of the reference C++
CILQR stack, written fresh from the C++ semantics (NOT translated to be fast,
translated to be *exact*).  The JAX engine is asserted against this to
<= 1e-3 on control trajectories (BASELINE.md parity bar).

Every function cites the C++ it mirrors.  Quirks intentionally kept:
  * Jacobians at successor states (iLQR.cpp:102-106).
  * V seeded from step N-1 running cost (iLQR.cpp:108-113).
  * Acceptance cost J on the pre-update trajectory (iLQR.cpp:217) excluding
    every barrier term (Constraints.cpp:534-561).
  * Raw-power degree-5 polyfit via lstsq (LocalPlanner.cpp:101-117).
  * 200-sample closest-point densification (Constraints.cpp:24-59).
  * Eigenvalue-clamp Q_uu regularization (iLQR.cpp:155-175).
  * Backward-pass abort on an eigensolver failure (iLQR.cpp:159-162): a
    non-finite Q_uu or gain ends the LM loop with X/U/lambda kept
    (iLQR.cpp:213-215).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cilqr_tpu.utils.params import SolverParams


# ----------------------------------------------------------------- dynamics
def forward_simulate(p: SolverParams, x, u):
    """Model.cpp:17-30."""
    acc = min(max(u[0], p.acc_min), p.acc_max)
    yr_hi = x[2] * np.tan(p.steer_angle_max) / p.wheelbase
    yr_lo = x[2] * np.tan(p.steer_angle_min) / p.wheelbase
    yr = min(max(u[1], yr_lo), yr_hi)
    dt = p.timestep
    ds = x[2] * dt + 0.5 * acc * dt * dt
    return np.array(
        [
            x[0] + np.cos(x[3]) * ds,
            x[1] + np.sin(x[3]) * ds,
            min(max(x[2] + acc * dt, 0.0), p.speed_max),
            x[3] + yr * dt,
        ]
    )


def get_A(p: SolverParams, v, theta, acc):
    """Model.cpp:100-127 — returns fx (4,4) in standard orientation
    (the C++ stores the transpose and compensates in the backward pass)."""
    dt = p.timestep
    ds = v * dt + 0.5 * acc * dt * dt
    A = np.eye(4)
    A[0, 2] = dt * np.cos(theta)
    A[0, 3] = -np.sin(theta) * ds
    A[1, 2] = dt * np.sin(theta)
    A[1, 3] = np.cos(theta) * ds
    return A


def get_B(p: SolverParams, theta):
    """Model.cpp:139-155 — fu (4,2) standard orientation."""
    dt = p.timestep
    B = np.zeros((4, 2))
    B[0, 0] = 0.5 * dt * dt * np.cos(theta)
    B[1, 0] = 0.5 * dt * dt * np.sin(theta)
    B[2, 0] = dt
    B[3, 1] = dt
    return B


# ------------------------------------------------------------ local planner
def closest_point_index(plan_xy, point):
    """LocalPlanner.cpp:25-41.  plan_xy: (n, 2)."""
    d = np.sum((plan_xy - point[:2]) ** 2, axis=1)
    return int(np.argmin(d))


def polyfit(x, y, degree):
    """LocalPlanner.cpp:101-117: raw-power Vandermonde least squares."""
    V = np.vander(x, degree + 1, increasing=True)
    coeffs, *_ = np.linalg.lstsq(V, y, rcond=None)
    return coeffs


def get_local_wpts(p: SolverParams, plan_xy, ego_state):
    """LocalPlanner.cpp:47-60: window of up to num_of_local_wpts points."""
    i = closest_point_index(plan_xy, ego_state)
    n = min(plan_xy.shape[0] - i, p.num_of_local_wpts)
    return plan_xy[i : i + n]


def get_local_plan(p: SolverParams, plan_xy, ego_state):
    """LocalPlanner.cpp:66-96 -> (wpts (n,2) with fitted y, coeffs)."""
    w = get_local_wpts(p, plan_xy, ego_state)
    coeffs = polyfit(w[:, 0], w[:, 1], p.poly_order)
    y_fit = np.polyval(coeffs[::-1], w[:, 0])
    out = np.stack([w[:, 0], y_fit], axis=1)
    return out, coeffs


def find_closest_point(p: SolverParams, state, coeffs, x_local_plan):
    """Constraints.cpp:24-59."""
    n = p.num_of_local_wpts * 10
    dx = (x_local_plan[-1] - x_local_plan[0]) / n
    new_x = x_local_plan[0] + dx * np.arange(n)
    new_y = np.polyval(coeffs[::-1], new_x)
    d = (new_x - state[0]) ** 2 + (new_y - state[1]) ** 2
    j = int(np.argmin(d))
    return np.array([new_x[j], new_y[j]])


# ------------------------------------------------------------------- costs
def barrier(q1, q2, c, c_dot):
    """Constraints.cpp:67-78."""
    b = q1 * np.exp(q2 * c)
    vx = q2 * b * c_dot
    mx = q2 * q2 * b * np.outer(c_dot, c_dot)
    return b, vx, mx


def control_cost_derivs(p: SolverParams, X, U):
    """Constraints.cpp:86-137.  X: (N+1,4), U: (N,2)."""
    N = U.shape[0]
    R = np.diag([p.w_acc, p.w_yawrate])
    e1 = np.array([1.0, 0.0])
    e2 = np.array([0.0, 1.0])
    l_u = np.zeros((N, 2))
    l_uu = np.zeros((N, 2, 2))
    for i in range(N):
        acc, yr = U[i]
        _, v1, m1 = barrier(p.q1_acc, p.q2_acc, acc - p.acc_max, e1)
        _, v2, m2 = barrier(p.q1_acc, p.q2_acc, p.acc_min - acc, -e1)
        hi = X[i, 2] * np.tan(p.steer_angle_max) / p.wheelbase
        lo = X[i, 2] * np.tan(p.steer_angle_min) / p.wheelbase
        _, v3, m3 = barrier(p.q1_yawrate, p.q2_yawrate, yr - hi, e2)
        _, v4, m4 = barrier(p.q1_yawrate, p.q2_yawrate, lo - yr, -e2)
        l_u[i] = v1 + v2 + v3 + v4 + 2.0 * R @ U[i]
        l_uu[i] = m1 + m2 + m3 + m4 + 2.0 * R
    return l_u, l_uu


def obstacle_cost(p: SolverParams, dims_i, pos_i, state):
    """Obstacle.cpp:39-112 for one obstacle at one step -> (vx(4), mx(4,4))."""
    a = dims_i[0] / 2.0 + abs(pos_i[2] * np.cos(pos_i[3])) * p.t_safe + p.s_safe_a + p.ego_rad
    b = dims_i[1] / 2.0 + abs(pos_i[2] * np.sin(pos_i[3])) * p.t_safe + p.s_safe_b + p.ego_rad + 1.0
    P1 = np.zeros((4, 4))
    P1[0, 0] = 1.0 / a / a
    P1[1, 1] = 1.0 / b / b
    th = pos_i[3]
    tf = np.zeros((4, 4))
    tf[0, 0] = np.cos(th)
    tf[0, 1] = np.sin(th)
    tf[1, 0] = -np.sin(th)
    tf[1, 1] = np.cos(th)
    tfr = np.zeros((4, 4))
    tfr[0, 0] = np.cos(th)
    tfr[0, 1] = -np.sin(th)
    tfr[1, 0] = np.sin(th)
    tfr[1, 1] = np.cos(th)

    vth = state[3]
    out_v = np.zeros(4)
    out_m = np.zeros((4, 4))
    for sign, reach, q1, q2 in (
        (+1.0, p.ego_front, p.q1_front, p.q2_front),
        (-1.0, p.ego_rear, p.q1_rear, p.q2_rear),
    ):
        ego = state.copy()
        ego[0] = state[0] + sign * np.cos(vth) * reach
        ego[1] = state[1] + sign * np.sin(vth) * reach
        diff = tf @ (ego - pos_i)
        c = 1.0 - diff @ P1 @ diff
        c_dot = -2.0 * tfr @ P1 @ diff
        _, vx, mx = barrier(q1, q2, c, c_dot)
        out_v += vx
        out_m += mx
    return out_v, out_m


@dataclasses.dataclass
class OracleUncertainty:
    """Reconstructed Uncertainty class (missing Uncertainty.h — see
    cilqr_tpu/models/uncertainty.py for the full semantics derivation)."""

    values: np.ndarray      # (rows, cols) occupancy [0,100]
    center: np.ndarray      # (2,) grid center in map frame
    resolution: float
    origin_xy: np.ndarray   # (2,) global position of map frame
    origin_yaw: float

    def sample(self, local):
        rows, cols = self.values.shape
        length = np.array([rows * self.resolution, cols * self.resolution])
        first = self.center + 0.5 * length - 0.5 * self.resolution
        ci = (first[0] - local[0]) / self.resolution
        cj = (first[1] - local[1]) / self.resolution
        fi = min(max(ci, 0.0), rows - 1.0)
        fj = min(max(cj, 0.0), cols - 1.0)
        i0 = int(min(max(np.floor(fi), 0), rows - 2))
        j0 = int(min(max(np.floor(fj), 0), cols - 2))
        ti, tj = fi - i0, fj - j0
        v = self.values
        v0 = v[i0, j0] * (1 - tj) + v[i0, j0 + 1] * tj
        v1 = v[i0 + 1, j0] * (1 - tj) + v[i0 + 1, j0 + 1] * tj
        val = v0 * (1 - ti) + v1 * ti
        dv_di = v1 - v0
        dv_dj = (v[i0, j0 + 1] - v[i0, j0]) * (1 - ti) + (v[i0 + 1, j0 + 1] - v[i0 + 1, j0]) * ti
        inv = -1.0 / self.resolution
        return val, np.array([dv_di * inv, dv_dj * inv])

    def inside(self, local):
        rows, cols = self.values.shape
        length = np.array([rows * self.resolution, cols * self.resolution])
        lo = self.center - 0.5 * length
        hi = self.center + 0.5 * length
        return bool(np.all(local >= lo) and np.all(local <= hi))

    def get_uncertainty_cost(self, p: SolverParams, state):
        d = state[:2] - self.origin_xy
        cy, sy = np.cos(self.origin_yaw), np.sin(self.origin_yaw)
        local = np.array([cy * d[0] + sy * d[1], -sy * d[0] + cy * d[1]])
        u, g_local = self.sample(local)
        if not self.inside(local):
            return 0.0, np.zeros(4), np.zeros((4, 4))
        c = u / 100.0
        g_c = g_local / 100.0
        g = np.array([cy * g_c[0] - sy * g_c[1], sy * g_c[0] + cy * g_c[1]])
        e = p.q1_uncertainty * np.exp(p.q2_uncertainty * c)
        vx = np.zeros(4)
        vx[:2] = p.q2_uncertainty * e * g
        mx = np.zeros((4, 4))
        mx[:2, :2] = p.q2_uncertainty**2 * e * np.outer(g, g)
        return e, vx, mx


def state_cost_derivs(p: SolverParams, X, coeffs, x_local_plan, obstacles=None, unc=None):
    """Constraints.cpp:145-227.  X: (N+1, 4) -> l_x (N,4), l_xx (N,4,4)."""
    N = p.horizon
    Q = np.diag([p.w_pos, p.w_pos, p.w_vel, 0.0])
    l_x = np.zeros((N, 4))
    l_xx = np.zeros((N, 4, 4))
    for i in range(N):
        cp = find_closest_point(p, X[i], coeffs, x_local_plan)
        err = np.array([X[i, 0] - cp[0], X[i, 1] - cp[1], X[i, 2] - p.desired_speed, 0.0])
        l_x[i] = 2.0 * Q @ err
        l_xx[i] = 2.0 * Q
        if obstacles is not None:
            for dims, pos in obstacles:
                vx, mx = obstacle_cost(p, dims[i], pos[i], X[i])
                l_x[i] += p.w_obstacle * vx
                l_xx[i] += p.w_obstacle * mx
        if unc is not None:
            _, vx, mx = unc.get_uncertainty_cost(p, X[i])
            l_x[i] += p.w_uncertainty * vx
            l_xx[i] += p.w_uncertainty * mx
    return l_x, l_xx


def get_J(p: SolverParams, X, U, coeffs, x_local_plan):
    """Constraints.cpp:534-561 (barriers excluded; pre-update trajectory)."""
    Q = np.diag([p.w_pos, p.w_pos, p.w_vel, 0.0])
    R = np.diag([p.w_acc, p.w_yawrate])
    J = 0.0
    for i in range(p.horizon):
        cp = find_closest_point(p, X[i], coeffs, x_local_plan)
        diff = np.array([X[i, 0] - cp[0], X[i, 1] - cp[1], X[i, 2] - p.desired_speed, X[i, 3]])
        J += diff @ Q @ diff + U[i] @ R @ U[i]
    return J


# ------------------------------------------------------------------ solver
def rollout(p: SolverParams, x0, U):
    """iLQR.cpp:51-62."""
    X = np.zeros((p.horizon + 1, 4))
    X[0] = x0
    for i in range(p.horizon):
        X[i + 1] = forward_simulate(p, X[i], U[i])
    return X


def backward_pass(p: SolverParams, X, U, coeffs, x_local_plan, lamb, obstacles=None, unc=None):
    """iLQR.cpp:91-195 -> (k, K), or None when the pass aborts
    (iLQR.cpp:159-162)."""
    N = p.horizon
    l_x, l_xx = state_cost_derivs(p, X, coeffs, x_local_plan, obstacles, unc)
    l_u, l_uu = control_cost_derivs(p, X, U)

    V_x = l_x[N - 1].copy()
    V_xx = l_xx[N - 1].copy()
    k = np.zeros((N, 2))
    K = np.zeros((N, 2, 4))
    for j in range(N - 1, -1, -1):
        fx = get_A(p, X[j + 1, 2], X[j + 1, 3], U[j, 0])
        fu = get_B(p, X[j + 1, 3])
        Q_x = l_x[j] + fx.T @ V_x
        Q_u = l_u[j] + fu.T @ V_x
        Q_xx = l_xx[j] + fx.T @ V_xx @ fx
        Q_ux = fu.T @ V_xx @ fx
        Q_uu = l_uu[j] + fu.T @ V_xx @ fu
        if not np.isfinite(Q_uu).all():
            return None

        w, V = np.linalg.eig(Q_uu)
        w = np.real(w)
        V = np.real(V)
        w = 1.0 / (np.maximum(w, 0.0) + lamb)
        Q_uu_inv = V @ np.diag(w) @ V.T

        k[j] = -Q_uu_inv @ Q_u
        K[j] = -Q_uu_inv @ Q_ux
        if not (np.isfinite(k[j]).all() and np.isfinite(K[j]).all()):
            return None
        V_x = Q_x - K[j].T @ Q_uu @ k[j]
        V_xx = Q_xx - K[j].T @ Q_uu @ K[j]
    return k, K


def forward_pass(p: SolverParams, X, U, k, K):
    """iLQR.cpp:68-86."""
    N = p.horizon
    X_new = np.zeros_like(X)
    U_new = np.zeros_like(U)
    X_new[0] = X[0]
    for i in range(N):
        U_new[i] = U[i] + k[i] + K[i] @ (X_new[i] - X[i])
        X_new[i + 1] = forward_simulate(p, X_new[i], U_new[i])
    return X_new, U_new


def optimize(p: SolverParams, x0, U, coeffs, x_local_plan, obstacles=None, unc=None):
    """iLQR.cpp:201-245 -> (X, U, iterations)."""
    X = rollout(p, x0, U)
    U = U.copy()
    J_old = np.finfo(np.float64).max
    lamb = p.lamb_init
    iters = 0
    for _ in range(p.max_iterations):
        iters += 1
        gains = backward_pass(p, X, U, coeffs, x_local_plan, lamb, obstacles, unc)
        if gains is None:  # iLQR.cpp:213-215
            J_old = get_J(p, X, U, coeffs, x_local_plan)
            break
        k, K = gains
        X_new, U_new = forward_pass(p, X, U, k, K)
        J_new = get_J(p, X, U, coeffs, x_local_plan)
        if J_new < J_old:
            X, U = X_new, U_new
            lamb /= p.lamb_factor
            if abs(J_new - J_old) < p.tolerance:
                J_old = J_new
                break
        else:
            lamb *= p.lamb_factor
            if lamb > p.lamb_max:
                J_old = J_new
                break
        J_old = J_new
    return X, U, iters, J_old, lamb


def run_step(p: SolverParams, plan_xy, ego_state, U_warm, obstacles=None, unc=None):
    """iLQR.cpp:247-255 -> (X, U, ref_traj, iters)."""
    local_plan, coeffs = get_local_plan(p, plan_xy, ego_state)
    X, U, iters, J, lamb = optimize(
        p, ego_state, U_warm, coeffs, local_plan[:, 0], obstacles, unc
    )
    return X, U, local_plan, iters, J, lamb
