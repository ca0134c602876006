"""1D reaction-diffusion (parabolic) PDE with boundary control.

PDE: ``u_t = u_xx + β(x) u`` on x ∈ [0, X], fixed ``u(0,t) = 0``, controlled at
x = X. The state carries a ghost point: ``state_dim = nx + 1``
(``parabolic.py:123-124``), so full-state observations have nx+1 entries.

Two schemes:

- ``explicit`` (reference parity, ``parabolic.py:141-151``): FTCS with Fourier
  number ``F = dt/dx²``; the interior uses the previous row, ``u[0] = 0``, and
  the boundary is written from the control using the *previous* row's ``[-2]``
  entry for the Neumann neighbor (``parabolic.py:148-150`` — unlike transport,
  which reads the new row).
- ``implicit`` (not in the reference; BASELINE config 3): θ-scheme
  (θ=1 backward Euler, θ=0.5 Crank-Nicolson) on both diffusion and reaction,
  solved per sub-step by a batched tridiagonal solve (``ops/tridiag``: PCR by
  default, Thomas, or a dense propagator matmul — see
  ``ReactionDiffusionConfig.implicit_solver``). Stable for any ``dt``, so far
  fewer sub-steps are needed per control interval.
"""

from __future__ import annotations

import dataclasses


import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.common import Boundary1DConfig, Boundary1DEnv
from pdecontrolgym_jax.ops.tridiag import pcr, thomas


@dataclasses.dataclass(frozen=True)
class ReactionDiffusionConfig(Boundary1DConfig):
    T: float = 1.0
    dt: float = 1e-5
    dx: float = 5e-3
    control_sample_rate: float = 1e-4  # parabolic.py:34 default
    scheme: str = "explicit"  # "explicit" (parity) or "implicit"
    theta: float = 1.0  # implicit only: 1.0 = backward Euler, 0.5 = CN
    # implicit sub-step solver:
    # - "thomas": batched O(n) forward/back sweeps (2n sequential scan
    #   steps; works with any per-env β)
    # - "pcr": parallel cyclic reduction, O(log n) vectorized steps (works
    #   with any per-env β). The interval kernel (ops/pallas1d) runs it with
    #   the coefficient elimination hoisted to once per interval.
    # - "dense": precompute the affine propagator u⁺ = P·u + q·b once on the
    #   host and apply it as ONE batched matmul per sub-step — the θ-scheme
    #   operators are constant; requires an env-invariant β
    # - "auto" (default): pcr. dense stays opt-in: it bakes the IC sampler's
    #   β into the propagator at construction, which would be silently wrong
    #   for users driving ``init_from`` with a different β
    implicit_solver: str = "auto"


class ReactionDiffusionEnv(Boundary1DEnv):
    left_dirichlet_fixed_zero = True  # parabolic.py:85,114

    def __init__(self, config, reward, ic_sampler=None, noise_fn=None):
        super().__init__(config, reward, ic_sampler, noise_fn)
        if getattr(config, "scheme", "explicit") not in ("explicit", "implicit"):
            raise ValueError(f"Invalid scheme {config.scheme!r}")
        solver = getattr(config, "implicit_solver", "auto")
        if solver not in ("auto", "thomas", "pcr", "dense"):
            raise ValueError(f"Invalid implicit_solver {solver!r}")
        self._solver = "pcr" if solver == "auto" else solver
        if config.scheme == "implicit" and self._solver == "dense":
            # must be built EAGERLY (omnistaging would stage the host
            # precompute if triggered inside a jit trace)
            self._dense_propagator()

    @property
    def state_dim(self) -> int:
        return self.config.nx + 1  # ghost point

    def _kernel_wins(self) -> bool:
        # measured faster than XLA on an H100 (PERF.md): FTCS at 201
        # points, Crank-Nicolson PCR at 257; sizes past 512 padded columns
        # were not measured and stay on XLA
        if getattr(self.config, "scheme", "explicit") == "implicit":
            return self._solver == "pcr" and self.state_dim <= 512
        return self.state_dim <= 512

    def _advance(self, u_prev, beta, control):
        c = self.config
        boundary = self._control_fn(control, u_prev[-2])
        if getattr(c, "scheme", "explicit") == "implicit":
            if self._solver == "dense":
                P, q = self._dense_propagator()
                # one (n,)@(n,n) per env — vmap batches it into a single
                # (B,n)@(n,n) matmul per sub-step (vs 2n sequential scan
                # steps for the Thomas sweeps)
                u_new = jnp.dot(P, u_prev, precision="highest") + q * boundary
            else:
                u_new = self._implicit_interior(u_prev, beta, boundary)
        else:
            F = c.dtype(c.dt / c.dx**2)
            dt = c.dtype(c.dt)
            # folded FTCS: u·(1 − 2F + dt·β) + F·(um + up) — 3 fewer vector
            # ops per point than u + F·(um − 2u + up) + dt·β·u; the kernel
            # body (ops/pallas1d.reaction_diffusion_spec) uses the same
            # association. ~1 ulp/sub-step drift vs the reference's
            # association; parity is tolerance-based
            diag = (1.0 - 2.0 * F) + beta[1:-1] * dt
            interior = F * (u_prev[:-2] + u_prev[2:]) + u_prev[1:-1] * diag
            u_new = jnp.concatenate(
                [jnp.zeros((1,), c.dtype), interior, boundary[None]]
            )
        return u_new, boundary

    def _dense_propagator(self):
        """Host-precomputed affine θ-scheme propagator ``u⁺ = P·u + q·b``.

        ``(I − θ·dt·L) u⁺ = (I + (1−θ)·dt·L) u`` with pinned edge rows is an
        affine map with CONSTANT operators (β is a fixed plant parameter), so
        ``P = T⁻¹E`` and ``q = T⁻¹e_{n-1}`` are computed once in float64 and
        each sub-step becomes a batched dense matmul. Requires β to be
        env-invariant — verified against the IC sampler at build time.
        """
        cached = getattr(self, "_dense_cache", None)
        if cached is None:
            import numpy as np

            c = self.config
            ic = self.ic_sampler or self.default_ic
            beta = np.asarray(jax.device_get(ic(jax.random.key(0))[1]), np.float64)
            beta_b = np.asarray(jax.device_get(ic(jax.random.key(1))[1]), np.float64)
            if not np.array_equal(beta, beta_b):
                raise ValueError(
                    "implicit_solver='dense' requires an env-invariant beta "
                    "(the IC sampler returned different beta for different "
                    "keys); use implicit_solver='thomas'"
                )
            n = self.state_dim
            F = float(c.dt) / float(c.dx) ** 2
            th, dt = float(c.theta), float(c.dt)
            T = np.eye(n)
            E = np.zeros((n, n))
            for i in range(1, n - 1):
                T[i, i - 1] = T[i, i + 1] = -th * F
                T[i, i] = 1.0 + th * (2.0 * F - dt * beta[i])
                E[i, i - 1] = E[i, i + 1] = (1.0 - th) * F
                E[i, i] = 1.0 + (1.0 - th) * (dt * beta[i] - 2.0 * F)
            e_last = np.zeros(n)
            e_last[-1] = 1.0
            P = np.linalg.solve(T, E)
            q = np.linalg.solve(T, e_last)
            cached = (
                jnp.asarray(P, c.dtype),
                jnp.asarray(q, c.dtype),
            )
            self._dense_cache = cached
        return cached

    def _implicit_interior(self, u_prev, beta, boundary):
        """One θ-scheme sub-step: (I − θ·dt·L) u⁺ = (I + (1−θ)·dt·L) u with
        L = ∂²/∂x² + diag(β), Dirichlet rows pinned to u(0)=0 and u(X)=control."""
        c = self.config
        n = self.state_dim
        dt, th = c.dtype(c.dt), c.dtype(c.theta)
        F = c.dtype(c.dt / c.dx**2)

        lower = jnp.full((n,), -th * F, c.dtype)
        upper = jnp.full((n,), -th * F, c.dtype)
        diag = 1.0 + th * (2.0 * F - dt * beta)
        # explicit part of the operator
        expl = (1.0 - th) * (
            F * (jnp.roll(u_prev, 1) - 2.0 * u_prev + jnp.roll(u_prev, -1))
            + dt * beta * u_prev
        )
        rhs = u_prev + expl
        # pin boundary rows: u[0] = 0, u[-1] = boundary
        edge = jnp.zeros((n,), c.dtype).at[0].set(1.0).at[-1].set(1.0)
        lower = jnp.where(edge > 0, 0.0, lower)
        upper = jnp.where(edge > 0, 0.0, upper)
        diag = jnp.where(edge > 0, 1.0, diag)
        rhs = rhs.at[0].set(0.0).at[-1].set(boundary)
        solve = pcr if self._solver == "pcr" else thomas
        return solve(lower, diag, upper, rhs)

    def _kernel_spec(self):
        from pdecontrolgym_jax.core.sensing import is_neumann
        from pdecontrolgym_jax.ops.pallas1d import (
            reaction_diffusion_implicit_spec,
            reaction_diffusion_spec,
        )

        c = self.config
        scheme = getattr(c, "scheme", "explicit")
        if scheme == "implicit" and self._solver != "pcr":
            return None  # thomas/dense stay XLA paths
        neumann = is_neumann(c.control_type)
        if neumann and c.normalize:
            # normalize() wraps the state-dependent Neumann update; not
            # expressible as a constant per-interval control — XLA path
            return None
        if scheme == "implicit":
            spec = reaction_diffusion_implicit_spec(
                c.dt, c.dx, self.state_dim, float(getattr(c, "theta", 1.0)),
                neumann,
            )
        else:
            spec = reaction_diffusion_spec(c.dt, c.dx, self.state_dim, neumann)
        if neumann:
            ctrl = lambda control: control
        else:
            zero = jnp.zeros((), c.dtype)
            ctrl = lambda control: self._control_fn(control, zero)
        return spec, ctrl

    def default_ic(self, key):
        """Flat IC of height U(1,10) and β(x) = 50·cos(8·acos x) on the
        ghost-point grid (``reactionDiffusion1DBackstepping.py:42-48``)."""
        c = self.config
        height = jax.random.uniform(key, (), c.dtype, 1.0, 10.0)
        u0 = jnp.full((self.state_dim,), height, c.dtype)
        x = jnp.linspace(0.0, 1.0, self.state_dim)
        beta = (50.0 * jnp.cos(8.0 * jnp.arccos(x))).astype(c.dtype)
        return u0, beta
