"""1D Burgers (nonlinear hyperbolic) PDE with boundary control.

``u_t + (u²/2)_x = ν·u_xx`` on x ∈ [0, X], controlled at x = X.

This env has no counterpart in the reference package — it is required by the
benchmark suite (BASELINE.json config 2: "1D Burgers, Dirichlet boundary
control, nx=256") — so the scheme is chosen for robustness rather than parity:
a first-order finite-volume update with, by default, the Godunov flux — the
EXACT Riemann solver for the convex Burgers flux, which for f(u)=u²/2 reduces
to the closed form ``F = max(f(max(ul,0)), f(min(ur,0)))`` (LeVeque, FVM for
Hyperbolic Problems §12.2). It is both less dissipative than the Rusanov
(local Lax-Friedrichs) flux and ~25% fewer vector ops on the hot path
(no |u| / face-speed max chain). ``flux="rusanov"`` keeps the round-1 scheme.
Optional explicit viscous diffusion is folded into the face flux either way.
The env plugs into the same Boundary1DEnv machinery (control zero-order hold,
norm ring, TunedReward compatibility, sensing variants).

Left boundary: zero-gradient outflow (``u[0] = u[1]``). Right boundary:
Dirichlet (the action) or Neumann (action·dx + u[-2]).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.common import Boundary1DConfig, Boundary1DEnv


@dataclasses.dataclass(frozen=True)
class BurgersConfig(Boundary1DConfig):
    T: float = 1.0
    dt: float = 1e-4
    X: float = 1.0
    dx: float = 1.0 / 256.0
    control_sample_rate: float = 0.01
    viscosity: float = 1e-3
    flux: str = "godunov"  # "godunov" (exact Riemann, default) | "rusanov"
    scan_unroll: int = 4  # the heavier flux-form body unrolls less


class BurgersEnv(Boundary1DEnv):
    def _kernel_wins(self) -> bool:
        # measured faster than XLA on an H100 at nx=256 (PERF.md); sizes
        # past 512 padded columns were not measured and stay on XLA
        return self.state_dim <= 512

    def _advance(self, u_prev, beta, control):
        c = self.config
        dt, dx = c.dtype(c.dt), c.dtype(c.dx)
        nu = c.dtype(c.viscosity)
        boundary = self._control_fn(control, u_prev[-2])

        # Face flux at the nx-1 interior faces, with the explicit viscous
        # term folded into the same face flux (F -= ν·(u_r−u_l)/dx): the
        # flux difference then reproduces ν·dt/dx²·(u_{i-1}−2u_i+u_{i+1})
        # exactly, one fewer stencil pass on the hot sub-step path.
        ul, ur = u_prev[:-1], u_prev[1:]
        if c.flux == "godunov":
            # exact Riemann flux for f(u)=u²/2: covers both shock (max of
            # endpoint fluxes when the fan converges) and transonic
            # rarefaction (F=0 when ul<0<ur) in one branch-free form;
            # max(f(max(ul,0)), f(min(ur,0))) = f(max(ul,-ur,0)) since f is
            # convex and even — one fewer vector op, same algebra as the
            # interval kernel (ops/pallas1d.burgers_spec)
            m = jnp.maximum(jnp.maximum(ul, -ur), 0.0)
            flux = 0.5 * (m * m)
        else:  # rusanov
            coef = 0.5 * jnp.maximum(jnp.abs(ul), jnp.abs(ur))
            flux = 0.25 * (ul * ul + ur * ur) - coef * (ur - ul)
        if c.viscosity:
            flux = flux - (nu / dx) * (ur - ul)

        interior = u_prev[1:-1] - dt / dx * (flux[1:] - flux[:-1])
        left = interior[0]  # zero-gradient outflow
        u_new = jnp.concatenate([left[None], interior, boundary[None]])
        return u_new, boundary

    def _kernel_spec(self):
        from pdecontrolgym_jax.core.sensing import is_neumann
        from pdecontrolgym_jax.ops.pallas1d import burgers_spec

        c = self.config
        neumann = is_neumann(c.control_type)
        if neumann and c.normalize:
            return None
        spec = burgers_spec(c.dt, c.dx, self.state_dim, c.viscosity,
                            neumann, c.flux)
        if neumann:
            ctrl = lambda control: control
        else:
            zero = jnp.zeros((), c.dtype)
            ctrl = lambda control: self._control_fn(control, zero)
        return spec, ctrl

    def default_ic(self, key):
        """Smooth random IC: height·sin(πx) with height ~ U(0.5, 2)."""
        c = self.config
        height = jax.random.uniform(key, (), c.dtype, 0.5, 2.0)
        x = jnp.linspace(0.0, 1.0, self.state_dim)
        u0 = (height * jnp.sin(jnp.pi * x)).astype(c.dtype)
        beta = jnp.zeros((self.state_dim,), c.dtype)
        return u0, beta
