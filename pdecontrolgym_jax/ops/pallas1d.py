"""Pallas (Triton) kernel: a whole control interval of 1D PDE sub-steps per launch.

Under XLA the sub-step loop is a ``lax.scan``: every sub-step is at least one
kernel launch inside a device ``while`` loop, 50,000 of them per transport
episode, while each moves only ~2 MB (4096 envs x 128 points x 4 B) that
sits in L2 anyway. This kernel runs all ``S`` sub-steps of one interval in
one launch and writes the state back once.

Layout: each program owns a tile of ``TB`` envs (rows) x ``NP`` points
(columns; the state axis zero-padded to a power of two, as Triton tensors
must be). Its rows stay in registers for the whole interval. Triton gives a
kernel no addressable shared memory, so neighbour values travel through a
two-slot staging buffer in global memory that only this program touches:
``exchange(v)`` stores ``v`` into the next slot, barriers the block, and
returns a gather over that slot. The slot written by one exchange is read
only after the next exchange's barrier, so one barrier per exchange is
enough. The buffer is a few KB per program and stays in L1/L2.

The per-PDE sub-step is a function ``update(x, ex, fac, ctrl, cols)`` over
the ``(TB, NP)`` register tile, returning ``(x_new, boundary)``; ``ex`` is
the exchange and ``fac`` the loaded per-env factor tiles. External contract:
``fn(u, beta, ctrl, t0) -> (u_out, norms, bsum_add, t_out)`` with ``u`` and
``beta`` in the usual ``(B, state_dim)`` layout, ``ctrl`` and ``t0`` of
shape ``(B, 1)``, and ``norms`` of shape ``(B, min(window, S))``: column
``i`` is the L2 norm after sub-step ``S - min(window, S) + i``, evaluated at
``norm_positions`` only (other columns are zero), exactly as the XLA scan
in ``envs/common.py`` returns them. Envs whose episode ends inside the
interval are frozen sub-step by sub-step, as on the XLA path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton



def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class KernelSpec(NamedTuple):
    """What an env hands the interval kernel.

    ``update``: the sub-step (see the module docstring). ``factors``:
    ``beta -> tuple of (B, width)`` per-env arrays, width at most the padded
    column count, computed once per interval in XLA (loop-invariant
    coefficients; zero-padded to the tile). ``boundary_const``: the
    boundary value equals ``ctrl`` at every sub-step, so its running sum is
    ``|ctrl| x executed`` and need not be accumulated. ``tile_elems`` and
    ``num_warps``: state elements and warps per program. The stencil bodies
    keep 2048 elements (16 envs at nx=128: 256 programs for 4096 envs, two
    per SM of an H100); the PCR body holds ~20 factor tiles in registers
    and needs 512 elements over 8 warps to stay out of local memory (H100
    sweep in PERF.md)."""

    update: Callable
    factors: Callable
    boundary_const: bool
    tile_elems: int = 2048
    num_warps: int = 4


def make_interval_fn(
    spec: KernelSpec,
    *,
    sample_rate: int,
    nt: int,
    state_dim: int,
    window: int,
    norm_positions: Optional[tuple] = None,
    interpret: bool = False,
):
    """Build ``fn(u, beta, ctrl, t0) -> (u_out, norms, bsum_add, t_out)``
    running ``sample_rate`` sub-steps of ``spec.update`` per call (the
    contract in the module docstring). ``interpret=True`` runs the kernel
    in the Pallas interpreter (CPU tests); otherwise it compiles through
    Triton for the GPU."""
    S = sample_rate
    Wn = min(window, S)
    WP = _pow2(Wn)
    first = S - Wn  # sub-step whose norm lands in column 0
    if norm_positions is None:
        norm_positions = tuple(range(first, S))
    NP = _pow2(max(state_dim, 2))
    TB = max(1, spec.tile_elems // NP)
    D = state_dim

    def kernel(u_ref, ctrl_ref, t0_ref, *refs):
        nf = len(refs) - 5
        fac_refs = refs[:nf]
        uo_ref, norms_ref, bsum_ref, to_ref, stage = refs[nf:]
        x = u_ref[...]
        fac = tuple(r[...] for r in fac_refs)
        ctrl = ctrl_ref[...]  # (TB, 1)
        t0 = t0_ref[...]  # (TB, 1) int32
        rows = jax.lax.broadcasted_iota(jnp.int32, (TB, NP), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (TB, NP), 1)
        slot_col = jax.lax.broadcasted_iota(jnp.int32, (TB, WP), 1)

        def substep(j, carry, with_norm):
            x, bsum, norms, n_ex = carry
            count = [n_ex]

            def ex(v):
                slot = jax.lax.bitwise_and(count[0], jnp.int32(1))
                stage[slot, rows, cols] = v
                if not interpret:
                    pltriton.debug_barrier()
                count[0] = count[0] + 1

                def gather(idx):
                    idx = jnp.asarray(idx, jnp.int32)
                    if idx.ndim == 0:  # one column, broadcast per env
                        r = jax.lax.broadcasted_iota(jnp.int32, (TB, 1), 0)
                        return stage[slot, r, jnp.full((TB, 1), idx)]
                    ok = (idx >= 0) & (idx < NP)
                    return pltriton.load(
                        stage.at[slot, rows, jnp.clip(idx, 0, NP - 1)],
                        mask=ok, other=0.0,
                    )

                return gather

            xn, boundary = spec.update(x, ex, fac, ctrl, cols)
            active = (t0 + j) < nt - 1  # (TB, 1)
            xn = jnp.where(active & (cols < D), xn, jnp.where(cols < D, x, 0.0))
            if not spec.boundary_const:
                bsum = bsum + jnp.where(active, jnp.abs(boundary), 0.0)
            if with_norm:
                nrm = jnp.sqrt(jnp.sum(xn * xn, axis=1, keepdims=True))
                norms = jnp.where(slot_col == j - first, nrm, norms)
            return xn, bsum, norms, count[0]

        def loop(lo, hi, carry, with_norm):
            if hi - lo == 1:
                return substep(lo, carry, with_norm)
            return jax.lax.fori_loop(
                lo, hi, lambda j, c: substep(j, c, with_norm), carry
            )

        carry = (
            x,
            jnp.zeros((TB, 1), x.dtype),
            jnp.zeros((TB, WP), x.dtype),
            jnp.int32(0),
        )
        start = 0
        for j in norm_positions:  # static segments between norm positions
            if j > start:
                carry = loop(start, j, carry, False)
            carry = substep(j, carry, True)
            start = j + 1
        if S > start:
            carry = loop(start, S, carry, False)
        x, bsum, norms, _ = carry
        executed = jnp.clip(nt - 1 - t0, 0, S)
        if spec.boundary_const:
            bsum = jnp.abs(ctrl) * executed.astype(x.dtype)
        uo_ref[...] = x
        norms_ref[...] = norms
        bsum_ref[...] = bsum
        to_ref[...] = t0 + executed

    @jax.jit
    def fn(u, beta, ctrl, t0):
        B = u.shape[0]
        Bp = -(-B // TB) * TB
        dtype = u.dtype

        def pad(a, width, dt=dtype):
            return jnp.zeros((Bp, width), dt).at[:B, : a.shape[1]].set(
                a.astype(dt))

        factors = tuple(pad(f, NP) for f in spec.factors(beta))
        col = pl.BlockSpec((TB, NP), lambda i: (i, 0))
        one = pl.BlockSpec((TB, 1), lambda i: (i, 0))
        u_out, norms, bsum, t_out, _ = pl.pallas_call(
            kernel,
            grid=(Bp // TB,),
            in_specs=[col, one, one] + [col] * len(factors),
            out_specs=[
                col,
                pl.BlockSpec((TB, WP), lambda i: (i, 0)),
                one,
                one,
                pl.BlockSpec((2, TB, NP), lambda i: (0, i, 0)),
            ],
            out_shape=[
                jax.ShapeDtypeStruct((Bp, NP), dtype),
                jax.ShapeDtypeStruct((Bp, WP), dtype),
                jax.ShapeDtypeStruct((Bp, 1), dtype),
                jax.ShapeDtypeStruct((Bp, 1), jnp.int32),
                jax.ShapeDtypeStruct((2, Bp, NP), dtype),  # staging slots
            ],
            interpret=interpret,
            backend=None if interpret else "triton",
            compiler_params=None if interpret else pltriton.CompilerParams(
                num_warps=spec.num_warps, num_stages=1),
            name="interval_1d",
        )(pad(u, NP), pad(ctrl, 1), pad(t0, 1, jnp.int32), *factors)
        return u_out[:B, :D], norms[:B, :Wn], bsum[:B], t_out[:B]

    return fn


# -- per-PDE sub-steps (same schemes and association as the envs' XLA
# ``_advance``) -------------------------------------------------------------


def transport_spec(dt: float, dx: float, nx: int) -> KernelSpec:
    """Upwind transport (``envs/transport.py``): the boundary column is the
    pre-resolved control, constant over the interval; ``fac[0]`` is
    ``dt·β``."""
    dtdx = dt / dx

    def update(x, ex, fac, ctrl, cols):
        g = ex(x)
        xn = x + dtdx * (g(cols + 1) - x) + g(0) * fac[0]
        return jnp.where(cols == nx - 1, ctrl, xn), ctrl

    def factors(beta):
        return (beta * jnp.asarray(dt, beta.dtype),)

    return KernelSpec(update, factors, True)


def burgers_spec(dt: float, dx: float, nx: int, viscosity: float,
                 neumann: bool, flux: str = "godunov") -> KernelSpec:
    """Finite-volume Burgers (``envs/burgers.py``). Column 0 takes the new
    value of column 1 (zero-gradient outflow), so every column evaluates the
    stencil centred on ``max(col, 1)``."""
    dtdx = dt / dx
    nu_dx = viscosity / dx

    def face(ul, ur):
        if flux == "godunov":
            m = jnp.maximum(jnp.maximum(ul, -ur), 0.0)
            f = 0.5 * (m * m)
        else:  # rusanov
            coef = 0.5 * jnp.maximum(jnp.abs(ul), jnp.abs(ur))
            f = 0.25 * (ul * ul + ur * ur) - coef * (ur - ul)
        if viscosity:
            f = f - nu_dx * (ur - ul)
        return f

    def update(x, ex, fac, ctrl, cols):
        g = ex(x)
        c = jnp.maximum(cols, 1)
        xm, xc, xp = g(c - 1), g(c), g(c + 1)
        xn = xc - dtdx * (face(xc, xp) - face(xm, xc))
        boundary = ctrl * dx + g(nx - 2) if neumann else ctrl
        return jnp.where(cols == nx - 1, boundary, xn), boundary

    return KernelSpec(update, lambda beta: (), not neumann)


def reaction_diffusion_spec(dt: float, dx: float, n: int,
                            neumann: bool) -> KernelSpec:
    """FTCS reaction-diffusion (``envs/reaction_diffusion.py``, explicit):
    ``u·(1 − 2F + dt·β) + F·(um + up)``, ``u[0] = 0``, the Neumann boundary
    from the previous row's ``[n-2]``. ``fac[0]`` is the diagonal."""
    F = dt / dx**2

    def update(x, ex, fac, ctrl, cols):
        g = ex(x)
        xn = F * (g(cols - 1) + g(cols + 1)) + x * fac[0]
        boundary = ctrl * dx + g(n - 2) if neumann else ctrl
        xn = jnp.where(cols == 0, 0.0, xn)
        return jnp.where(cols == n - 1, boundary, xn), boundary

    def factors(beta):
        return ((1.0 - 2.0 * jnp.asarray(F, beta.dtype))
                + beta * jnp.asarray(dt, beta.dtype),)

    return KernelSpec(update, factors, not neumann)


def reaction_diffusion_implicit_spec(dt: float, dx: float, n: int,
                                     theta: float,
                                     neumann: bool) -> KernelSpec:
    """θ-scheme reaction-diffusion with a PCR solve per sub-step
    (``envs/reaction_diffusion.py:_implicit_interior``:
    ``(I − θ·dt·L) u⁺ = (I + (1−θ)·dt·L) u``, edge rows pinned to u(0)=0 and
    u(X)=control, L = ∂²/∂x² + diag(β)).

    The tridiagonal coefficients are constant over the interval, so the PCR
    elimination of (a, b, c) runs once per interval in XLA (``factors``) and
    each sub-step only reduces the right-hand side: ``ceil(log2 n)`` steps of
    ``d += α_k·d[i−s] + β_k·d[i+s]``, one exchange each, then ``d / b``.
    Out-of-range neighbours read zero, which is PCR's zero fill; padded
    columns are identity rows (a = c = 0, b = 1, d = 0)."""
    F = dt / dx**2
    th = float(theta)
    steps = max((max(n, 2) - 1).bit_length(), 1)
    NP = _pow2(max(n, 2))

    def factors(beta):
        dtc, Fc, thc = (jnp.asarray(v, beta.dtype) for v in (dt, F, th))
        col = jnp.arange(NP)
        interior = (col >= 1) & (col < n - 1)
        bpad = jnp.zeros(beta.shape[:-1] + (NP,), beta.dtype).at[..., :n].set(beta)
        b = jnp.where(interior, 1.0 + thc * (2.0 * Fc - dtc * bpad), 1.0)
        a = c = jnp.where(interior, -thc * Fc, 0.0).astype(beta.dtype)

        def shift(v, k, fill=0.0):  # v[..., i - k], filled where out of range
            lead = [(0, 0)] * (v.ndim - 1)
            if k > 0:
                return jnp.pad(v, lead + [(k, 0)], constant_values=fill)[..., :NP]
            return jnp.pad(v, lead + [(0, -k)], constant_values=fill)[..., -NP:]

        out = []
        s = 1
        for _ in range(steps):
            alpha = -a / shift(b, s, 1.0)
            beta_k = -c / shift(b, -s, 1.0)
            b = b + alpha * shift(c, s) + beta_k * shift(a, -s)
            a, c = alpha * shift(a, s), beta_k * shift(c, -s)
            out += [alpha, beta_k]
            s *= 2
        out.append(1.0 / b)
        if th < 1.0:
            out.append(1.0 + (1.0 - thc) * (dtc * bpad - 2.0 * Fc))
        return tuple(out)

    def update(x, ex, fac, ctrl, cols):
        g = ex(x) if (th < 1.0 or neumann) else None
        boundary = ctrl * dx + g(n - 2) if neumann else ctrl
        if th < 1.0:
            rhs = x * fac[2 * steps + 1] + ((1.0 - th) * F) * (
                g(cols - 1) + g(cols + 1))
        else:
            rhs = x
        keep = (cols >= 1) & (cols < n - 1)
        d = jnp.where(keep, rhs, jnp.where(cols == n - 1, boundary, 0.0))
        s = 1
        for k in range(steps):
            gd = ex(d)
            d = d + fac[2 * k] * gd(cols - s) + fac[2 * k + 1] * gd(cols + s)
            s *= 2
        return d * fac[2 * steps], boundary

    return KernelSpec(update, factors, not neumann, tile_elems=512,
                      num_warps=8)
