"""1D transport (linear hyperbolic) PDE with boundary control.

PDE: ``u_t = u_x + β(x) u(0, t)`` on x ∈ [0, X], controlled at x = X.

Scheme parity with ``src/environments1d/hyperbolic.py:140-156``:

- first-order explicit upwind: the new interior row (indices 0..nx-2) is
  ``u + dt·((u⁺ − u)/dx + u[0]·β)`` evaluated on the *previous* row,
- the boundary (index nx-1) is written from the control *before* the interior
  update, so Neumann control reads the new row's ``[-2]`` entry while it is
  still zero (``hyperbolic.py:143-145``) — i.e. the Neumann neighbor term is
  identically 0. Replicated for trajectory parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.common import Boundary1DConfig, Boundary1DEnv

TransportConfig = Boundary1DConfig


class TransportEnv(Boundary1DEnv):
    def _kernel_wins(self) -> bool:
        # measured faster than XLA on an H100 at nx=128 (PERF.md); sizes
        # past 512 padded columns were not measured and stay on XLA
        return self.state_dim <= 512

    def _advance(self, u_prev, beta, control):
        c = self.config
        dt = c.dtype(c.dt)
        dtdx = c.dtype(c.dt / c.dx)
        # Neumann neighbor is the NEW row's [-2], still zero at write time.
        boundary = self._control_fn(control, jnp.zeros((), c.dtype))
        # folded association (dt/dx pre-divided, beta pre-scaled by dt —
        # loop-invariant, XLA hoists it out of the sub-step scan), shared
        # with ops/pallas1d.transport_spec. Differs from the reference's
        # association by ~1 ulp/sub-step; parity suites are tolerance-based.
        interior = (
            u_prev[:-1]
            + dtdx * (u_prev[1:] - u_prev[:-1])
            + u_prev[0] * (dt * beta[:-1])
        )
        u_new = jnp.concatenate([interior, boundary[None]])
        return u_new, boundary

    def _kernel_spec(self):
        from pdecontrolgym_jax.ops.pallas1d import transport_spec

        c = self.config
        # the boundary value is constant over the interval for BOTH control
        # types (the Neumann neighbor reads the new row's still-zero [-2])
        zero = jnp.zeros((), c.dtype)
        return (
            transport_spec(c.dt, c.dx, self.state_dim),
            lambda control: self._control_fn(control, zero),
        )

    def default_ic(self, key):
        """Mirrors the benchmark example's samplers: a flat IC of height
        U(1, 10) and the Chebyshev recirculation β(x) = 5·cos(7.35·acos x)
        (``examples/transportPDE/transport1Dbackstepping.py:39-45``)."""
        c = self.config
        height = jax.random.uniform(key, (), c.dtype, 1.0, 10.0)
        u0 = jnp.full((self.state_dim,), height, c.dtype)
        beta = chebyshev_beta(self.state_dim, 7.35, 5.0, c.dtype)
        return u0, beta


def chebyshev_beta(nx: int, gamma: float = 7.35, scale: float = 5.0, dtype=jnp.float32):
    """β(x) = scale·cos(γ·acos x) on a uniform [0, 1] grid of nx points."""
    x = jnp.linspace(0.0, 1.0, nx)
    return (scale * jnp.cos(gamma * jnp.arccos(x))).astype(dtype)
