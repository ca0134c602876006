"""2D incompressible Navier-Stokes with per-edge boundary control.

Chorin projection scheme with parity to ``src/environments2d/navier_stokes2D.py``:

1. explicit predictor ``u* = u + dt(−u·∇u + ν∇²u)`` (:137-138),
2. per-edge boundary application in the fixed order lower/upper/left/right ×
   (u, v), each edge Neumann (copy inner neighbor) / Dirichlet (zero) /
   Controllable (the action) (:68-91),
3. pressure-Poisson solve by fixed-iteration Jacobi (:94-116),
4. corrector ``u' = u* − dt/ρ·∇p`` + boundary re-application (:144-146).

Grid conventions copied from ``base_env_2d.py:27-36``: ``nt = round(T/dt)``,
``nx = round(X/dx + 1)``; fields are indexed ``[y, x]`` (the reference's
"x" derivative varies the last axis); the episode runs nt−1 steps.

The construction-time diffusion stability guard (:56-58) is preserved,
including its message. The ``U_ref``/``action_ref`` tracking targets live on
device as env constants.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.core import pytree
from pdecontrolgym_jax.core.base import FunctionalEnv, RewardCtx, StepOut
from pdecontrolgym_jax.ops.poisson2d import (
    ddx,
    ddy,
    direct_pressure,
    direct_pressure_setup,
    jacobi_pressure,
    jacobi_pressure_flat,
    laplacian,
    matpow_pressure,
    matpow_pressure_setup,
)

_EDGES = ("lower", "upper", "left", "right")
_CONDITIONS = ("Neumann", "Dirchilet", "Dirichlet", "Controllable")


@dataclasses.dataclass(frozen=True)
class NavierStokesConfig:
    T: float = 0.2
    dt: float = 1e-3
    X: float = 1.0
    dx: float = 0.05
    Y: float = 1.0
    dy: float = 0.05
    action_dim: int = 1
    viscosity: float = 0.1
    density: float = 1.0
    maximum_pressure_iteration: int = 2000
    stable_factor: float = 0.5
    normalize: bool = False
    dtype: Any = jnp.float64
    pressure_layout: str = "grid"  # "grid" (parity) | "flat" (lane-flattened)
    # "jacobi": the reference's fixed-iteration sweep (parity at 2000 iters).
    # "matpow": the SAME affine map collapsed to two precomputed dense
    # matmuls (ops/poisson2d.matpow_pressure) — reproduces the reference's
    # finite-iteration truncation error to ~1e-11 at f64, at matmul speed;
    # (ny·nx)² memory, so reference-sized grids only.
    # "direct": exact spectral solve of the same fixed point via DCT-II
    # matmuls (ops/poisson2d.direct_pressure) — the fast mode; it ignores
    # maximum_pressure_iteration and is MORE accurate than any finite sweep.
    pressure_solver: str = "jacobi"
    # step_batch's tracking-target lookup. True (default): ONE shared
    # U_ref[t] slice for the whole batch — NS batches are always
    # time-lockstep through the public APIs (fixed-length episodes that never
    # truncate + batched init/autoreset), so no runtime check is needed.
    # False: runtime `(t == t[0]).all()` cond falling back to a per-env
    # gather — only needed for hand-built batches with mixed time indices.
    lockstep_targets: bool = True
    # per-edge (u_condition, v_condition) ordered (lower, upper, left, right);
    # default mirrors the examples' dict: controllable lid at the upper edge
    # (``NS2Dppo.py:21-26``). Use freeze_boundary_condition() to convert a dict.
    boundary_condition: tuple = (
        ("Dirchilet", "Dirchilet"),
        ("Controllable", "Dirchilet"),
        ("Dirchilet", "Dirchilet"),
        ("Dirchilet", "Dirchilet"),
    )

    @property
    def nt(self) -> int:
        return int(round(self.T / self.dt))  # base_env_2d.py:27 (no +1)

    @property
    def nx(self) -> int:
        return int(round(self.X / self.dx + 1))

    @property
    def ny(self) -> int:
        return int(round(self.Y / self.dy + 1))


def make_lid_target(config: "NavierStokesConfig", lid: float = 2.0,
                    u0=None, v0=None, p0=None):
    """Roll out the env under a constant lid velocity and return the
    ``(nt, ny, nx, 2)`` tracking trajectory plus the matching action sequence
    — the engine-generated equivalent of the reference's ``target.npz``
    (``examples/NavierStokes/NS2Dppo.py:33-35``). Shared by the PPO/target
    examples so the target convention lives in exactly one place."""
    from pdecontrolgym_jax.rewards.ns import NSReward

    nt, n = config.nt, config.nx
    shape = (config.ny, config.nx)
    zeros = jnp.zeros(shape, config.dtype)
    u0 = zeros if u0 is None else jnp.asarray(u0, config.dtype)
    v0 = zeros if v0 is None else jnp.asarray(v0, config.dtype)
    p0 = zeros if p0 is None else jnp.asarray(p0, config.dtype)
    env = NavierStokesEnv(
        config, NSReward(0.1),
        jnp.zeros((nt, n, n, 2), config.dtype), jnp.zeros(nt, config.dtype),
    )
    state, obs0 = env.init_from(u0, v0, p0)

    def body(state, _):
        state, out = env.step(state, jnp.asarray([lid], config.dtype))
        return state, out.obs

    _, frames = jax.lax.scan(body, state, None, length=nt - 1)
    U_ref = jnp.concatenate([obs0[None], frames])
    return U_ref, lid * jnp.ones(nt, config.dtype)


def freeze_boundary_condition(bc: dict) -> tuple:
    """Normalize the reference's dict format into a hashable config tuple."""
    out = []
    for pos in _EDGES:
        conds = tuple(bc[pos])
        for c in conds:
            if c not in _CONDITIONS:
                raise ValueError(f"Invalid boundary condition {c!r} at {pos!r}")
        out.append(conds)
    return tuple(out)


@pytree.dataclass
class NavierStokesState:
    u: jnp.ndarray  # (ny, nx) x-velocity  [row=y, col=x like the reference]
    v: jnp.ndarray
    p: jnp.ndarray
    time_index: jnp.ndarray  # int32


class NavierStokesEnv(FunctionalEnv):
    def __init__(
        self,
        config: NavierStokesConfig,
        reward,
        U_ref,
        action_ref,
        ic_sampler: Optional[Callable] = None,
    ):
        c = config
        max_t = 0.5 * min(c.dx, c.dy) ** 2 / c.viscosity
        if c.dt > c.stable_factor * max_t:
            raise RuntimeError("Stability is not guarenteed")  # sic, :58
        self.config = c
        self.reward = reward
        self.U_ref = jnp.asarray(U_ref, c.dtype)
        self.action_ref = jnp.asarray(action_ref, c.dtype)
        self.ic_sampler = ic_sampler
        solver = getattr(c, "pressure_solver", "jacobi")
        self._poisson_basis = (
            direct_pressure_setup(c.ny, c.nx, c.dtype) if solver == "direct" else None
        )
        self._matpow_mats = (
            matpow_pressure_setup(
                c.ny, c.nx, c.dx, c.dy, c.maximum_pressure_iteration, c.dtype
            )
            if solver == "matpow"
            else None
        )
    @property
    def fixed_episode_length(self):
        """Episodes ALWAYS run exactly nt−1 steps (terminate at t ≥ nt−1,
        never truncate — ``navier_stokes2D.py:154-157`` returns
        ``truncated=False`` unconditionally). Lets ``parallel/rollout``
        drop the per-step masked autoreset for lockstep batches."""
        return self.config.nt - 1

    @property
    def obs_shape(self):
        return (self.config.nx, self.config.ny, 2)

    @property
    def action_dim(self):
        return self.config.action_dim

    # -- boundary application -------------------------------------------------

    def _apply_boundary(self, u, v, action):
        """Static unroll of the reference's edge loop (:76-91); write order
        lower, upper, left, right — replicated so corner overwrites match.

        Implemented as masked SELECTS rather than sequential
        ``.at[edge].set`` writes, each of which can materialize the full
        batched field (8 edge writes per application). The where
        chain applies in the same order, so corner overwrites are
        identical, and Neumann edges read the CURRENT field's inner
        neighbor exactly like the write form did."""
        c = self.config
        ny, nx = u.shape[-2], u.shape[-1]
        act = jnp.asarray(action, c.dtype).reshape(-1)
        if act.shape[0] == 1:
            a_row = a_col = act[0]  # scalar broadcast like ref
        else:
            # vector controls lie along the edge: (nx,) rows for
            # lower/upper, (ny,) columns for left/right
            a_row, a_col = act, act[:, None]
        row = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1)
        edges = {
            "lower": row == 0, "upper": row == ny - 1,
            "left": col == 0, "right": col == nx - 1,
        }

        def shift_y(f, k):
            z = jnp.zeros(f.shape[:-2] + (1, f.shape[-1]), f.dtype)
            if k == 1:
                return jnp.concatenate([f[..., 1:, :], z], axis=-2)
            return jnp.concatenate([z, f[..., :-1, :]], axis=-2)

        def shift_x(f, k):
            z = jnp.zeros(f.shape[:-1] + (1,), f.dtype)
            if k == 1:
                return jnp.concatenate([f[..., 1:], z], axis=-1)
            return jnp.concatenate([z, f[..., :-1]], axis=-1)

        neighbor = {
            "lower": lambda f: shift_y(f, 1),
            "upper": lambda f: shift_y(f, -1),
            "left": lambda f: shift_x(f, 1),
            "right": lambda f: shift_x(f, -1),
        }
        avals = {"lower": a_row, "upper": a_row, "left": a_col,
                 "right": a_col}
        out = []
        for i, f in enumerate((u, v)):
            for pos, conds in zip(_EDGES, self.config.boundary_condition):
                cond = conds[i]
                if cond == "Neumann":
                    f = jnp.where(edges[pos], neighbor[pos](f), f)
                elif cond == "Controllable":
                    f = jnp.where(edges[pos], avals[pos], f)
                else:  # Dirichlet / "Dirchilet"
                    f = jnp.where(edges[pos], jnp.zeros_like(f), f)
            out.append(f)
        return out[0], out[1]

    # -- protocol -------------------------------------------------------------

    def default_ic(self, key):
        """u, v, p = independent U(−5,5) constants (``NS2Dppo.py:14-18``)."""
        c = self.config
        vals = jax.random.uniform(key, (3,), c.dtype, -5.0, 5.0)
        shape = (c.ny, c.nx)
        return (
            jnp.full(shape, vals[0], c.dtype),
            jnp.full(shape, vals[1], c.dtype),
            jnp.full(shape, vals[2], c.dtype),
        )

    def init(self, key):
        if self.ic_sampler is not None:
            u0, v0, p0 = self.ic_sampler(key)
        else:
            u0, v0, p0 = self.default_ic(key)
        return self.init_from(u0, v0, p0)

    def init_from(self, u0, v0, p0):
        """Build a fresh state from (ny, nx) fields."""
        c = self.config
        state = NavierStokesState(
            u=jnp.asarray(u0, c.dtype),
            v=jnp.asarray(v0, c.dtype),
            p=jnp.asarray(p0, c.dtype),
            time_index=jnp.asarray(0, jnp.int32),
        )
        return state, self._observe(state)

    def _observe(self, state):
        # obs frame (nx, ny, 2) like U[time_index] (base_env_2d.py:50)
        return jnp.stack([state.u, state.v], axis=-1)

    def solve_pressure(self, u, v, p_prev, iters: Optional[int] = None):
        c = self.config
        if self._poisson_basis is not None:
            return direct_pressure(
                u, v, p_prev, c.dx, c.dy, c.dt, c.density, self._poisson_basis
            )
        if self._matpow_mats is not None and (
            iters is None or iters == c.maximum_pressure_iteration
        ):
            return matpow_pressure(
                u, v, p_prev, c.dx, c.dy, c.dt, c.density, self._matpow_mats
            )
        solver = (
            jacobi_pressure_flat
            if getattr(c, "pressure_layout", "grid") == "flat"
            else jacobi_pressure
        )
        return solver(
            u, v, p_prev, c.dx, c.dy, c.dt, c.density,
            iters if iters is not None else c.maximum_pressure_iteration,
        )

    def _projection(self, u, v, p, action):
        """One projection step of the physics: predictor → boundary →
        pressure → corrector → boundary (``navier_stokes2D.py:118-157``)."""
        c = self.config
        nu, dt = c.viscosity, c.dt

        dudx, dudy = ddx(u, c.dx), ddy(u, c.dy)
        dvdx, dvdy = ddx(v, c.dx), ddy(v, c.dy)
        u_pred = u + dt * (-u * dudx - v * dudy + nu * laplacian(u, c.dx, c.dy))
        v_pred = v + dt * (-u * dvdx - v * dvdy + nu * laplacian(v, c.dx, c.dy))
        u_pred, v_pred = self._apply_boundary(u_pred, v_pred, action)

        pressure = self.solve_pressure(u_pred, v_pred, p)
        u_next = u_pred - dt / c.density * ddx(pressure, c.dx)
        v_next = v_pred - dt / c.density * ddy(pressure, c.dy)
        u_next, v_next = self._apply_boundary(u_next, v_next, action)
        return u_next, v_next, pressure

    def _advance(self, state: NavierStokesState, action):
        """Physics + bookkeeping; reward is applied separately so
        ``step_batch`` can share the tracking-target lookup."""
        c = self.config
        u_next, v_next, pressure = self._projection(
            state.u, state.v, state.p, action
        )
        t = state.time_index + 1
        new_state = NavierStokesState(
            u=u_next, v=v_next, p=pressure, time_index=t,
        )
        frame = jnp.stack([u_next, v_next], axis=-1)
        terminated = t >= c.nt - 1
        return new_state, frame, terminated, t

    def _reward_at(self, frame, t, terminated, action, frame_ref, action_ref):
        c = self.config
        ctx = RewardCtx(
            u=frame,
            time_index=t,
            executed=jnp.asarray(1, jnp.int32),
            terminated=terminated,
            truncated=False,
            action=jnp.asarray(action, c.dtype),
            norms=jnp.zeros((1,), c.dtype),
            bsum=jnp.zeros((), c.dtype),
            ring=1,
            extras={
                "frame": frame,
                "frame_ref": frame_ref,
                "action": action,
                "action_ref": action_ref,
            },
        )
        return self.reward(ctx)

    def step(self, state: NavierStokesState, action, key=None):
        new_state, frame, terminated, t = self._advance(state, action)
        reward = self._reward_at(
            frame, t, terminated, action, self.U_ref[t], self.action_ref[t]
        )
        return new_state, StepOut(
            obs=frame,
            reward=reward,
            terminated=terminated,
            truncated=False,
            info={},
        )

    def step_batch(self, state: NavierStokesState, actions):
        """Batched step with a lockstep-aware tracking-target lookup.

        Under ``vmap(env.step)`` the per-env ``U_ref[t]`` row lookup lowers to
        a gather per env. NS episodes never truncate, so a
        rollout batch is ALWAYS time-lockstep through the public APIs (fixed
        nt-1-step episodes, no truncation, batched init/autoreset), so by
        default (``config.lockstep_targets``) the shared slice is used
        unconditionally. ``lockstep_targets=False`` restores
        the runtime check with the per-env gather fallback for hand-built
        mixed-time batches."""
        new_state, frames, terminated, ts = jax.vmap(self._advance)(
            state, actions
        )
        U_ref_c = self.U_ref

        def shared_ref(_):
            row = jax.lax.dynamic_index_in_dim(U_ref_c, ts[0], 0, keepdims=False)
            arow = jax.lax.dynamic_index_in_dim(self.action_ref, ts[0], 0, keepdims=False)
            return jax.vmap(
                lambda fr, tt, term, ac: self._reward_at(fr, tt, term, ac, row, arow)
            )(frames, ts, terminated, actions)

        def gathered_ref(_):
            return jax.vmap(self._reward_at)(
                frames, ts, terminated, actions, U_ref_c[ts], self.action_ref[ts]
            )

        if getattr(self.config, "lockstep_targets", True):
            reward = shared_ref(None)
            # fail LOUD on hand-built mixed-time batches instead of silently
            # rewarding every env against env 0's target row (the check is
            # one (B,) compare + select — the round-2 lax.cond this replaces
            # was the expensive part, not the comparison)
            reward = jnp.where((ts == ts[0]).all(), reward, jnp.nan)
        else:
            reward = jax.lax.cond(
                (ts == ts[0]).all(), shared_ref, gathered_ref, None
            )
        return new_state, StepOut(
            obs=frames,
            reward=reward,
            terminated=terminated,
            truncated=jnp.zeros_like(terminated),
            info={},
        )
