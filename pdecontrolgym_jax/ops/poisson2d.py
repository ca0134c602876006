"""Batched 2D field ops for the Navier-Stokes projection solver.

Mirrors the semantics of the reference helpers ``central_difference`` /
``laplace`` (``src/environments2d/navier_stokes2D.py:9-22``: interior-only,
zero borders) and the fixed-iteration Jacobi pressure-Poisson sweep with
sequential Neumann edge copies (``navier_stokes2D.py:94-116``). All functions
are pure jnp on ``(..., nx, ny)`` arrays so a batch of envs runs in one fused
program; the Jacobi loop is a ``lax.fori_loop`` that XLA keeps on-device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ddx(f, dx):
    """Interior central difference along axis -1 (the reference's "x"),
    zero on the border ring."""
    out = jnp.zeros_like(f)
    return out.at[..., 1:-1, 1:-1].set(
        (f[..., 1:-1, 2:] - f[..., 1:-1, :-2]) / (2.0 * dx)
    )


def ddy(f, dy):
    """Interior central difference along axis -2 (the reference's "y")."""
    out = jnp.zeros_like(f)
    return out.at[..., 1:-1, 1:-1].set(
        (f[..., 2:, 1:-1] - f[..., :-2, 1:-1]) / (2.0 * dy)
    )


def laplacian(f, dx, dy):
    """Interior 5-point Laplacian scaled by 1/(dx·dy) (reference convention,
    ``navier_stokes2D.py:17-22``), zero on the border ring."""
    out = jnp.zeros_like(f)
    return out.at[..., 1:-1, 1:-1].set(
        (
            f[..., 1:-1, :-2]
            + f[..., :-2, 1:-1]
            - 4.0 * f[..., 1:-1, 1:-1]
            + f[..., 1:-1, 2:]
            + f[..., 2:, 1:-1]
        )
        / (dx * dy)
    )


def _neumann_edges(p):
    """The reference's sequential pressure BC writes (order matters at the
    corners): right col ← its neighbor, then top row, left col, bottom row
    (``navier_stokes2D.py:110-113``)."""
    p = p.at[..., :, -1].set(p[..., :, -2])
    p = p.at[..., 0, :].set(p[..., 1, :])
    p = p.at[..., :, 0].set(p[..., :, 1])
    p = p.at[..., -1, :].set(p[..., -2, :])
    return p


def jacobi_pressure_flat(u, v, p0, dx, dy, dt, density, iters: int):
    """Semantically identical to :func:`jacobi_pressure`, with the grid
    flattened into the trailing (lane) axis: a (ny, nx) field becomes a
    row-major (ny·nx,) vector, neighbor access becomes lane rolls of ±1 / ±nx,
    and edge handling becomes masked selects. A layout choice for the same
    arithmetic; the grid layout is the parity default.
    """
    ny, nx = u.shape[-2], u.shape[-1]
    lead = u.shape[:-2]
    n = ny * nx
    uf = u.reshape(lead + (n,))
    vf = v.reshape(lead + (n,))
    pf = p0.reshape(lead + (n,))

    idx = jnp.arange(n)
    row = idx // nx
    col = idx % nx
    interior = (row >= 1) & (row <= ny - 2) & (col >= 1) & (col <= nx - 2)

    def sh(x, k):
        return jnp.roll(x, -k, axis=-1)  # sh(x, k)[i] = x[i + k]

    rhs = jnp.where(
        interior,
        density / dt * (
            (sh(uf, 1) - sh(uf, -1)) / (2.0 * dx)
            + (sh(vf, nx) - sh(vf, -nx)) / (2.0 * dy)
        ),
        0.0,
    )

    def body(_, p):
        interior_val = 0.25 * (
            sh(p, -1) + sh(p, -nx) + sh(p, 1) + sh(p, nx) - dx * dy * rhs
        )
        p = jnp.where(interior, interior_val, p)
        # sequential Neumann edge copies (reference order, corners included)
        p = jnp.where(col == nx - 1, sh(p, -1), p)
        p = jnp.where(row == 0, sh(p, nx), p)
        p = jnp.where(col == 0, sh(p, 1), p)
        p = jnp.where(row == ny - 1, sh(p, -nx), p)
        return p

    pf = jax.lax.fori_loop(0, iters, body, pf)
    return pf.reshape(lead + (ny, nx))


def dct2_basis(n: int, dtype=jnp.float32):
    """Orthonormal DCT-II basis Q (n, n): columns q_k[j] =
    c_k·cos(πk(2j+1)/(2n)) diagonalize the mirror-Neumann 1D Laplacian
    A = tridiag(−1, 2, −1) with A[0,0] = A[n−1,n−1] = 1 — exactly the
    operator of the reference's Jacobi fixed point, where ring cells copy
    their inner neighbor each sweep (``navier_stokes2D.py:104-114``).
    Eigenvalues: λ_k = 2 − 2cos(πk/n)."""
    import numpy as np

    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    q = np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    q *= np.where(k == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
    lam = 2.0 - 2.0 * np.cos(np.pi * np.arange(n) / n)
    return jnp.asarray(q, dtype), jnp.asarray(lam, dtype)


def direct_pressure_setup(ny: int, nx: int, dtype=jnp.float32):
    """Precompute the spectral factors for :func:`direct_pressure` on the
    (ny−2)×(nx−2) interior grid. Returns a pytree of device constants."""
    m, n = ny - 2, nx - 2
    qy, ly = dct2_basis(m, dtype)
    qx, lx = dct2_basis(n, dtype)
    denom = ly[:, None] + lx[None, :]
    inv = jnp.where(denom > 0, 1.0 / jnp.maximum(denom, 1e-30), 0.0)
    return {"qy": qy, "qx": qx, "inv": inv}


def direct_pressure(u, v, p0, dx, dy, dt, density, basis):
    """Direct (spectral) solve of the pressure-Poisson fixed point — the fast
    mode that replaces thousands of Jacobi sweeps with four dense matmuls.

    The Jacobi iteration the reference runs 2000× converges (on the
    orthogonal complement of the constant mode) to the solution of
    ``L P = −dx·dy·RHS`` with L the 2D mirror-Neumann Laplacian; the constant
    mode never converges (pure-Neumann singularity) and is irrelevant because
    only ∇p enters the corrector. Here L is diagonalized by the DCT-II basis
    (:func:`dct2_basis`), so the exact solution is
    ``P = Q_y · [(Q_yᵀ G Q_x) ⊘ (λ_y ⊕ λ_x)] · Q_xᵀ`` with the (0,0) mode
    zeroed — batched einsums (matmuls). More accurate than ANY finite
    Jacobi iteration count and ~3 orders of magnitude cheaper than 2000
    sweeps. ``p0`` is accepted for signature parity and ignored (direct
    solves need no initial guess)."""
    qy, qx, inv = basis["qy"], basis["qx"], basis["inv"]
    # interior divergence directly from slices (== (ddx(u)+ddy(v))[1:-1,1:-1]
    # without materializing the zero-bordered temporaries)
    g = (-dx * dy * density / dt) * (
        (u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / (2.0 * dx)
        + (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / (2.0 * dy)
    )
    # spectral transform: T = Qyᵀ @ G @ Qx  (batched over leading axes).
    # precision="highest": an unannotated f32 matmul runs in TF32 on an
    # H100's tensor cores (~1e-3 relative), defeating the "exact spectral
    # solve" contract; full f32 is still ~3 orders under 2000 sweeps
    t = jnp.einsum("im,...ij,jn->...mn", qy, g, qx, precision="highest")
    t = t * inv  # per-mode inverse eigenvalue; (0,0) null mode -> 0
    p_int = jnp.einsum("im,...mn,jn->...ij", qy, t, qx, precision="highest")
    # embed with the reference's mirror ring (sequential copy order so the
    # corner values match what a converged Jacobi sweep leaves behind)
    p = jnp.zeros_like(u)
    p = p.at[..., 1:-1, 1:-1].set(p_int.astype(u.dtype))
    return _neumann_edges(p)


def matpow_pressure_setup(ny: int, nx: int, dx, dy, iters: int, dtype=jnp.float32):
    """Collapse ``iters`` Jacobi sweeps into two dense matrices.

    One sweep of the reference's pressure iteration
    (``navier_stokes2D.py:104-114``) is an *affine* map on the flattened
    (ny·nx,) pressure vector: interior averaging + rhs add, then four
    sequential Neumann edge copies — all linear. So

        p_{k+1} = M p_k + w,   w = c·E·mask·rhs,  c = −dx·dy/4

    and ``iters`` sweeps are exactly

        p_K = A p_0 + B rhs,   A = M^K,  B = c·(Σ_{j<K} M^j)·E·mask

    with A, B precomputed here in float64 by binary powering of the pair
    ``(M, S) ∘ (M, S) = (M², M·S + S)`` (the affine-map composition rule).
    At the reference's 21×21 grid these are 441×441 matrices: the whole
    2000-iteration parity solve becomes two matmuls per step, with the
    reference's *finite-iteration truncation error reproduced exactly* —
    unlike the spectral ``direct`` mode, which is the converged fixed point.
    Memory/flops scale as (ny·nx)², so this is the reference-sized-grid
    accelerator; use ``direct`` for large grids."""
    import numpy as np

    n = ny * nx
    idx = np.arange(n)
    row, col = idx // nx, idx % nx
    interior = (row >= 1) & (row <= ny - 2) & (col >= 1) & (col <= nx - 2)

    # W: interior rows average the four neighbors, boundary rows identity
    W = np.zeros((n, n))
    bd = np.flatnonzero(~interior)
    W[bd, bd] = 1.0
    ii = np.flatnonzero(interior)
    for off in (1, -1, nx, -nx):
        W[ii, ii + off] += 0.25

    def edge_copy(dst_mask, src_offset):
        E = np.eye(n)
        d = np.flatnonzero(dst_mask)
        E[d, d] = 0.0
        E[d, d + src_offset] = 1.0
        return E

    # sequential order of _neumann_edges: right col, bottom row (row 0),
    # left col, top row (row ny-1) — corners follow the copy chain
    E = edge_copy(col == nx - 1, -1)
    E = edge_copy(row == 0, nx) @ E
    E = edge_copy(col == 0, 1) @ E
    E = edge_copy(row == ny - 1, -nx) @ E

    M = E @ W
    # rhs injection: interior rows get c·rhs before the edge copies
    c = -0.25 * float(dx) * float(dy)
    R = np.zeros((n, n))
    R[ii, ii] = c
    w_mat = E @ R

    # binary powering of the affine pair (A, S): p -> A p + S w
    A = np.eye(n)
    S = np.zeros((n, n))
    P, Q = M, np.eye(n)  # current power pair
    k = iters
    while k:
        if k & 1:
            A, S = P @ A, P @ S + Q
        P, Q = P @ P, P @ Q + Q
        k >>= 1
    B = S @ w_mat
    return {"A": jnp.asarray(A, dtype), "B": jnp.asarray(B, dtype)}


def matpow_pressure(u, v, p0, dx, dy, dt, density, mats):
    """Apply the precomputed ``iters``-sweep affine map (two batched matmuls;
    see :func:`matpow_pressure_setup`). Semantically identical to
    ``jacobi_pressure(..., iters)`` at f64 to ~1e-11."""
    ny, nx = u.shape[-2], u.shape[-1]
    lead = u.shape[:-2]
    rhs = jnp.zeros_like(u).at[..., 1:-1, 1:-1].set(
        density / dt * (
            (u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / (2.0 * dx)
            + (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / (2.0 * dy)
        )
    ).reshape(lead + (ny * nx,))
    pf = p0.reshape(lead + (ny * nx,))
    # an unannotated f32 matmul runs in TF32 on an H100; the parity contract
    # needs full f32 precision
    out = (
        jnp.einsum("ij,...j->...i", mats["A"], pf, precision="highest")
        + jnp.einsum("ij,...j->...i", mats["B"], rhs, precision="highest")
    )
    return out.reshape(lead + (ny, nx))


def jacobi_pressure(u, v, p0, dx, dy, dt, density, iters: int):
    """Fixed-iteration Jacobi solve of ∇²p = ρ/dt·(∂u/∂x + ∂v/∂y).

    ``iters=2000`` reproduces the reference exactly (no convergence check,
    ``navier_stokes2D.py:104-114``); smaller values give the fast mode.
    """
    rhs_c = density / dt * (
        (u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / (2.0 * dx)
        + (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / (2.0 * dy)
    )

    def body(_, p):
        interior = 0.25 * (
            p[..., 1:-1, :-2]
            + p[..., :-2, 1:-1]
            + p[..., 1:-1, 2:]
            + p[..., 2:, 1:-1]
            - dx * dy * rhs_c
        )
        p = p.at[..., 1:-1, 1:-1].set(interior)
        return _neumann_edges(p)

    return jax.lax.fori_loop(0, iters, body, p0)
