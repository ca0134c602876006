"""Batched tridiagonal solvers for implicit 1D schemes.

The reference has no implicit path (its parabolic env is explicit FTCS,
``parabolic.py:143-144``); this build owes one (BASELINE.json config 3:
"1D reaction-diffusion/heat, parabolic, implicit scheme, tridiagonal solve").

Two algorithms:

- :func:`thomas`: the classic O(n) forward/back sweep, expressed as two
  ``lax.scan``s whose per-row work is elementwise over arbitrary leading batch
  dims — each scan step is one elementwise op over the batch, so a
  4096-env batch amortizes the sequential depth.
- :func:`pcr`: parallel cyclic reduction, O(log n) fully-vectorized steps.
  Preferable when the batch is small or n is large.

All take ``(..., n)`` diagonals: ``lower[..., i]`` multiplies ``x[i-1]``
(``lower[..., 0]`` ignored), ``upper[..., i]`` multiplies ``x[i+1]``
(``upper[..., n-1]`` ignored).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def thomas(lower, diag, upper, rhs):
    """Solve tridiagonal systems by the Thomas algorithm. Batched over leading dims."""
    a = jnp.moveaxis(lower, -1, 0)
    b = jnp.moveaxis(diag, -1, 0)
    c = jnp.moveaxis(upper, -1, 0)
    d = jnp.moveaxis(rhs, -1, 0)

    def fwd(carry, row):
        cp_prev, dp_prev = carry
        a_i, b_i, c_i, d_i = row
        denom = b_i - a_i * cp_prev
        cp = c_i / denom
        dp = (d_i - a_i * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zero = jnp.zeros_like(b[0])
    _, (cp, dp) = jax.lax.scan(fwd, (zero, zero), (a, b, c, d))

    def bwd(x_next, row):
        cp_i, dp_i = row
        x = dp_i - cp_i * x_next
        return x, x

    _, x_rev = jax.lax.scan(bwd, zero, (cp, dp), reverse=True)
    return jnp.moveaxis(x_rev, 0, -1)


def pcr(lower, diag, upper, rhs):
    """Parallel cyclic reduction: O(log2 n) vectorized elimination steps."""
    a, b, c, d = lower, diag, upper, rhs
    n = d.shape[-1]
    steps = max((max(n, 2) - 1).bit_length(), 1)  # ceil(log2(n)), static

    def shift(x, k):
        """x[..., i] -> x[..., i-k] with zero fill (k may be negative)."""
        if k == 0:
            return x
        pad = [(0, 0)] * (x.ndim - 1)
        if k > 0:
            return jnp.pad(x, pad + [(k, 0)])[..., :n]
        return jnp.pad(x, pad + [(0, -k)])[..., -n:]

    stride = 1
    for _ in range(steps):
        am = shift(a, stride)  # row i-stride coefficients aligned to row i
        bm = shift(b, stride)
        cm = shift(c, stride)
        dm = shift(d, stride)
        ap = shift(a, -stride)
        bp = shift(b, -stride)
        cp_ = shift(c, -stride)
        dp_ = shift(d, -stride)
        bm = jnp.where(bm == 0, jnp.ones_like(bm), bm)
        bp = jnp.where(bp == 0, jnp.ones_like(bp), bp)
        alpha = -a / bm
        beta = -c / bp
        b = b + alpha * cm + beta * ap
        d = d + alpha * dm + beta * dp_
        a = alpha * am
        c = beta * cp_
        stride *= 2
    return d / b
