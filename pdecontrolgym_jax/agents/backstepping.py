"""PDE-backstepping boundary controllers (jittable, batched).

The reference ships these as example-script helpers:
- transport Volterra kernel via successive approximation
  (``examples/transportPDE/transport1Dbackstepping.py:22-36``)
- parabolic Goursat-domain kernel via an explicit FD recursion
  (``examples/reactionDiffusionPDE/reactionDiffusion1DBackstepping.py:22-39``)

Here they are pure JAX functions: gains are precomputed once per episode
(vmappable over a batch of β realizations) and the per-step control law is a
single dot product that fuses into the rollout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# -- 1D transport ------------------------------------------------------------


def transport_kernel(theta: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Backstepping gain for the transport PDE.

    Solves the discrete Volterra recursion
    ``κ[i] = dx·Σ_{j=1}^{i-1} κ[i−j]·θ[j] − θ[i]`` and returns the flipped
    gain vector, matching ``transport1Dbackstepping.py:22-29`` (whose j=0 term
    multiplies the not-yet-assigned κ[i]=0, hence the sum starting at j=1).

    ``theta`` is β evaluated on the shifted grid ``linspace(dx, X, nx)``.
    """
    n = theta.shape[0]
    idx = jnp.arange(n)

    def body(i, kappa):
        # gather κ[i-j]·θ[j] for j in [1, i)
        gathered = kappa[(i - idx) % n] * theta
        val = jnp.where((idx >= 1) & (idx < i), gathered, 0.0).sum()
        return kappa.at[i].set(dx * val - theta[i])

    kappa = jax.lax.fori_loop(0, n, body, jnp.zeros_like(theta))
    return kappa[::-1]


def transport_control(kernel: jnp.ndarray, obs: jnp.ndarray, dx: float):
    """U(t) = Σ κ[i]·u[i]·dx  (``transport1Dbackstepping.py:32-36``, where the
    1e-2 factor is the example's dx)."""
    # full f32: on an H100 an unannotated f32 dot runs in TF32 (~3 digits),
    # and this law closes the loop that parity is judged on
    return jnp.dot(kernel, obs, precision="highest") * dx


# -- 1D reaction-diffusion ----------------------------------------------------


def parabolic_kernel(beta: jnp.ndarray, dx: float) -> jnp.ndarray:
    """Goursat-domain backstepping kernel row k(X, ·) for the parabolic PDE.

    Explicit FD recursion over the triangular domain, matching
    ``reactionDiffusion1DBackstepping.py:22-35``; only the last row (the one
    the control law uses, line 39) is returned.

    ``beta`` has nx+1 entries (the ghost-point grid).
    """
    n = beta.shape[0]
    a = beta
    k = jnp.zeros((n, n), beta.dtype)
    k = k.at[1, 1].set(-(a[1] + a[0]) * dx / 4.0)

    idx = jnp.arange(n)

    def row(i, k):
        # diagonal / subdiagonal updates
        k = k.at[i + 1, i + 1].set(k[i, i] - dx / 4.0 * (a[i - 1] + a[i]))
        k = k.at[i + 1, i].set(k[i, i] - dx / 2.0 * a[i])
        # interior of the Goursat triangle: j in [1, i)
        interior = (
            -k[i - 1, idx]
            + k[i, (idx + 1) % n]
            + k[i, (idx - 1) % n]
            + a[idx] * (dx**2) * (k[i, (idx + 1) % n] + k[i, (idx - 1) % n]) / 2.0
        )
        mask = (idx >= 1) & (idx < i)
        new_row = jnp.where(mask, interior, k[i + 1, idx])
        return k.at[i + 1, :].set(new_row)

    k = jax.lax.fori_loop(1, n - 1, row, k)
    return k[n - 1]


def parabolic_control(kernel_row: jnp.ndarray, obs: jnp.ndarray, dx: float):
    """U(t) = Σ_{i<nx} k(X, x_i)·u_i·dx  (``reactionDiffusion1DBackstepping.py:38-39``)."""
    return jnp.dot(kernel_row[: obs.shape[0] - 1], obs[:-1],
                   precision="highest") * dx
