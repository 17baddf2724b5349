"""Closed-form 2x2 symmetric eigendecomposition — LAPACK-free Q_uu regularizer.

The reference regularizes Q_uu with a general Eigen::EigenSolver per backward
step (iLQR.cpp:155-175): eigenvalues clamped at >= 0, shifted by lambda,
inverted, and recomposed.  Q_uu is symmetric 2x2 by construction, so we use
the analytic decomposition — pure elementwise math, no data-dependent control
flow, batches over (scenario x timestep) for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def eigh2x2(M: jax.Array):
    """Eigenvalues/vectors of symmetric [[a, b], [b, c]] (batched ...x2x2).

    Returns (w (..., 2), V (..., 2, 2)) with columns of V the eigenvectors,
    w[..., 0] <= w[..., 1].
    """
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 1]
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    disc = jnp.sqrt(half_diff * half_diff + b * b)
    w_lo = half_tr - disc
    w_hi = half_tr + disc

    # Eigenvector for w_hi: (b, w_hi - a) unless b is negligible relative to
    # the diagonal (then the matrix is numerically diagonal).  The threshold
    # must be *relative*: an absolute ~1e-30 cutoff admits b values whose
    # squares underflow in f32, collapsing the normalizer to 0 (NaN) or
    # picking the wrong axis.
    scale = jnp.abs(a) + jnp.abs(c)
    eps = jnp.asarray(jnp.finfo(M.dtype).eps, M.dtype)
    safe = jnp.abs(b) > eps * scale
    vx = jnp.where(safe, b, jnp.where(a >= c, 1.0, 0.0))
    vy = jnp.where(safe, w_hi - a, jnp.where(a >= c, 0.0, 1.0))
    n = jnp.sqrt(vx * vx + vy * vy)
    vx = vx / n
    vy = vy / n
    # orthogonal complement for w_lo
    V = jnp.stack(
        [
            jnp.stack([-vy, vx], axis=-1),
            jnp.stack([vx, vy], axis=-1),
        ],
        axis=-1,
    )  # columns: [v_lo, v_hi]
    w = jnp.stack([w_lo, w_hi], axis=-1)
    return w, V


def regularized_inverse(M: jax.Array, lamb: jax.Array) -> jax.Array:
    """V diag(1 / (max(w, 0) + lamb)) V^T  (iLQR.cpp:164-175)."""
    w, V = eigh2x2(M)
    w_inv = 1.0 / (jnp.maximum(w, 0.0) + lamb[..., None])
    return jnp.einsum("...ik,...k,...jk->...ij", V, w_inv, V,
                      precision=jax.lax.Precision.HIGHEST)
