"""Aw–Rascle–Zhang (ARZ) traffic flow PDE with inlet/outlet flux control.

Coupled 2-state hyperbolic system in density ρ and "relative flow" y with the
Greenshields closure ``Veq(ρ) = v_m (1 − ρ/ρ_m)`` and relaxation ``−y/τ``,
advanced by the reference's two-step Richtmyer/Lax-Friedrichs midpoint scheme
(``src/environments1d/traffic_arz_env.py:173-222``).

Five simulation modes (``traffic_arz_env.py:45-72``): ``inlet``, ``outlet``,
``both`` (which boundary flux is the action; the other is pinned to q*), and
the stochastic-steady-state training variants ``inlet-train``/``outlet-train``.
The reference's ``inlet-train`` crashes on an unset ``q_inlet``
(``traffic_arz_env.py:159-171`` never assigns it); here it behaves as the
evident intent: controlled inlet + resampled steady state.

Reference quirks replicated for parity:

- ``time_index`` accumulates **dt** once per ``step()`` (not per sub-step, not
  an index; ``traffic_arz_env.py:148``), sub-steps gate on ``time_index < T``
  (:173), terminate fires at ``time_index ≥ T/dt`` and resets it to 0 (:109-111).
- boundary writes happen inside the sub-step loop in sequence: ρ₀←ρ₁,
  y₀←q_in−ρ₀·Veq(ρ₀), ρ_{M−1}←ρ_{M−2}, y_{M−1}←q_out−ρ_{M−1}·Veq(ρ_{M−1}).
- the action is clipped to the construction-time box [0.8·q*, 1.2·q*] (:152-157).
- non-train modes also terminate early when ``reward > −0.00023`` (:233);
  truncation on v/ρ limits or exact steady-state equality (:116-127).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.core import pytree
from pdecontrolgym_jax.core.base import FunctionalEnv, RewardCtx, StepOut

_MODES = ("inlet", "outlet", "both", "inlet-train", "outlet-train")
_TRAIN_RS = (0.115, 0.12, 0.125)  # traffic_arz_env.py:67,253


def veq(vm, rm, rho):
    return vm * (1.0 - rho / rm)


def flux_r(vm, rm, rho, y):
    return y + rho * veq(vm, rm, rho)


def flux_y(vm, rm, rho, y):
    return y * (y / rho + veq(vm, rm, rho))


@dataclasses.dataclass(frozen=True)
class TrafficARZConfig:
    T: float = 240.0
    dt: float = 0.25
    X: float = 500.0
    dx: float = 10.0
    simulation_type: str = "inlet"
    v_steady: float = 10.0
    ro_steady: float = 0.12
    v_max: float = 40.0
    ro_max: float = 0.16
    tau: float = 60.0
    limit_pde_state_size: bool = False
    control_freq: int = 1
    normalize: bool = False  # unused (actions are raw fluxes), kept for API parity
    dtype: Any = jnp.float32
    early_stop_threshold: float = -0.00023

    @property
    def M(self) -> int:
        # exactly len(arange(0, X+dx, dx)) — traffic_arz_env.py:74-76 — which
        # differs from round(X/dx)+1 when X/dx is not an integer
        import numpy as np

        return len(np.arange(0.0, self.X + self.dx, self.dx))

    @property
    def is_train(self) -> bool:
        return self.simulation_type.endswith("-train")

    def nominal_steady(self):
        """Construction-time (ρ*, v*, q*) — for train modes the reference draws
        a random one at __init__ only to size the action box; we use the
        config's ro_steady for a deterministic box (documented divergence)."""
        if self.is_train:
            rs = self.ro_steady
            vs = veq(self.v_max, self.ro_max, rs)
        else:
            rs, vs = self.ro_steady, self.v_steady
        return rs, vs, rs * vs


@pytree.dataclass
class TrafficARZState:
    r: jnp.ndarray  # (M,) density
    y: jnp.ndarray  # (M,) relative flow
    time_index: jnp.ndarray  # float accumulator (reference semantics)
    rs: jnp.ndarray  # per-episode steady density (train modes resample)
    vs: jnp.ndarray
    qs: jnp.ndarray


class TrafficARZEnv(FunctionalEnv):
    def __init__(self, config: TrafficARZConfig, reward):
        if config.simulation_type not in _MODES:
            raise ValueError("Invalid simulation type")
        if not (isinstance(config.control_freq, int) and config.control_freq >= 1):
            raise ValueError(
                f"control_freq must be a positive integer (got {config.control_freq})"
            )
        if not config.is_train:
            # equilibrium consistency check — traffic_arz_env.py:59-60
            if config.v_steady != veq(config.v_max, config.ro_max, config.ro_steady):
                raise ValueError(
                    "The steady state velocity and density do not satisfy the "
                    "equilibrium condition. Check the values of v_steady and "
                    "ro_steady and ensure that they obey "
                    "v_steady = v_max(1 - ro_steady/v_max)."
                )
        self.config = config
        self.reward = reward
        rs, vs, qs = config.nominal_steady()
        self.action_low = 0.8 * qs
        self.action_high = 1.2 * qs
        self.ps = config.v_max / config.ro_max * qs / vs  # traffic_arz_env.py:64

    @property
    def obs_dim(self) -> int:
        return 2 * self.config.M

    @property
    def action_dim(self) -> int:
        return 2 if self.config.simulation_type == "both" else 1

    # -- episode construction ------------------------------------------------

    def init(self, key: Optional[jax.Array] = None):
        c = self.config
        rs, vs, qs = c.nominal_steady()
        rs = jnp.asarray(rs, c.dtype)
        if c.is_train and key is not None:
            # stochastic steady-state resampling — traffic_arz_env.py:251-256
            idx = jax.random.randint(key, (), 0, len(_TRAIN_RS))
            rs = jnp.asarray(_TRAIN_RS, c.dtype)[idx]
        vs = veq(c.v_max, c.ro_max, rs).astype(c.dtype)
        qs = (rs * vs).astype(c.dtype)

        # IC — traffic_arz_env.py:258-261 (grid length pinned to config.M so
        # float-fence differences between np/jnp arange cannot desync shapes)
        x = (jnp.arange(c.M) * c.dx).astype(c.dtype)
        r = rs * (jnp.sin(3.0 * x / c.X * jnp.pi) * 0.1 + 1.0)
        y = qs - c.v_max * r + c.v_max / c.ro_max * r**2
        state = TrafficARZState(
            r=r.astype(c.dtype),
            y=y.astype(c.dtype),
            time_index=jnp.zeros((), c.dtype),
            rs=rs,
            vs=vs,
            qs=qs,
        )
        return state, self._observe(state)

    def _velocity(self, state):
        c = self.config
        return state.y / state.r + veq(c.v_max, c.ro_max, state.r)

    def _observe(self, state):
        v = self._velocity(state)
        if self.config.simulation_type == "outlet-train":
            # normalized deviations — traffic_arz_env.py:231
            return jnp.concatenate(
                [(state.r - state.rs) / state.rs, (v - state.vs) / state.vs]
            )
        return jnp.concatenate([state.r, v])

    def observe_batch(self, state):
        """Observation is a pure function of state (this env has no sensing
        noise), so batched rollouts may carry state only and recompute obs
        in-body (parallel/rollout) — XLA dead-codes the velocity
        reconstruction + concat whenever the policy ignores obs values."""
        return jax.vmap(self._observe)(state)

    # -- dynamics ------------------------------------------------------------

    def _substep(self, r, y, q_inlet, q_outlet):
        c = self.config
        vm, rm = c.dtype(c.v_max), c.dtype(c.ro_max)
        dt, dx, tau = c.dtype(c.dt), c.dtype(c.dx), c.dtype(c.tau)

        # sequential boundary writes (traffic_arz_env.py:174-190), built by
        # concatenation: the reference's in-place writes are 4 scatters
        # (dynamic-update-slices), each of which can materialize the full
        # array; concat emits one copy per array.
        # Values are identical: ρ₀←ρ₁, y₀←q_in−ρ₁·Veq(ρ₁) (the NEW ρ₀),
        # ρ_{M−1}←ρ_{M−2}, y_{M−1}←q_out−ρ_{M−2}·Veq(ρ_{M−2}).
        r_in = r[1]
        y_in = q_inlet - r_in * veq(vm, rm, r_in)
        r_out = r[-2]
        y_out = q_outlet - r_out * veq(vm, rm, r_out)
        r = jnp.concatenate([r_in[None], r[1:-1], r_out[None]])
        y = jnp.concatenate([y_in[None], y[1:-1], y_out[None]])

        rm1, r0, rp1 = r[:-2], r[1:-1], r[2:]
        ym1, y0, yp1 = y[:-2], y[1:-1], y[2:]
        lam = dt / (2.0 * dx)

        fr = lambda a, b: flux_r(vm, rm, a, b)
        fy = lambda a, b: flux_y(vm, rm, a, b)

        r_pmid = 0.5 * (rp1 + r0) - lam * (fr(rp1, yp1) - fr(r0, y0))
        r_mmid = 0.5 * (rm1 + r0) - lam * (fr(r0, y0) - fr(rm1, ym1))
        y_pmid = (
            0.5 * (yp1 + y0)
            - lam * (fy(rp1, yp1) - fy(r0, y0))
            - 0.25 * dt / tau * (yp1 + y0)
        )
        y_mmid = (
            0.5 * (ym1 + y0)
            - lam * (fy(r0, y0) - fy(rm1, ym1))
            - 0.25 * dt / tau * (ym1 + y0)
        )

        r_new = r0 - dt / dx * (fr(r_pmid, y_pmid) - fr(r_mmid, y_mmid))
        y_new = y0 - (
            dt / dx * (fy(r_pmid, y_pmid) - fy(r_mmid, y_mmid))
            + 0.5 * dt / tau * (y_pmid + y_mmid)
        )
        return (
            jnp.concatenate([r_in[None], r_new, r_out[None]]),
            jnp.concatenate([y_in[None], y_new, y_out[None]]),
        )

    def step(self, state: TrafficARZState, action, key=None):
        c = self.config
        mode = c.simulation_type
        t = state.time_index + c.dtype(c.dt)

        a = jnp.clip(
            jnp.asarray(action, c.dtype).reshape(-1),
            self.action_low,
            self.action_high,
        )
        if mode == "both":
            q_inlet, q_outlet = a[0], a[1]
        elif mode in ("inlet", "inlet-train"):
            q_inlet, q_outlet = a[0], state.qs
        else:  # outlet / outlet-train: fixed inlet, controlled outlet
            q_inlet, q_outlet = state.qs, a[0]

        active = t < c.T  # sub-step gate (traffic_arz_env.py:173)

        def run(carry, _):
            r, y = carry
            return self._substep(r, y, q_inlet, q_outlet), None

        (r_new, y_new), _ = jax.lax.scan(
            run, (state.r, state.y), None, length=c.control_freq
        )
        r = jnp.where(active, r_new, state.r)
        y = jnp.where(active, y_new, state.y)

        new_state = state.replace(r=r, y=y, time_index=t)
        v = self._velocity(new_state)

        ctx = RewardCtx(
            u=r,
            time_index=t,
            executed=jnp.asarray(c.control_freq, jnp.int32),
            terminated=False,
            truncated=False,
            action=a,
            norms=jnp.zeros((1,), c.dtype),
            bsum=jnp.zeros((), c.dtype),
            ring=1,
            extras={"v": v, "r": r, "vs": new_state.vs, "rs": new_state.rs},
        )
        reward = self.reward(ctx)

        time_terminated = t >= c.T / c.dt  # traffic_arz_env.py:109
        terminated = time_terminated
        if mode != "outlet-train":
            # every mode except outlet-train early-stops on the reward
            # threshold (the else-branch return at traffic_arz_env.py:233)
            terminated = jnp.logical_or(terminated, reward > c.early_stop_threshold)
        truncated = self._truncate(new_state, v)
        # reference terminate() zeroes the accumulator when the TIME condition
        # fires (:110) — not on the early-stop path
        new_state = new_state.replace(
            time_index=jnp.where(time_terminated, jnp.zeros((), c.dtype), t)
        )
        return new_state, StepOut(
            obs=self._observe(new_state),
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info={"V": v},
        )

    def _truncate(self, state, v):
        c = self.config
        blown = jnp.logical_or(jnp.any(v > c.v_max), jnp.any(state.r > c.ro_max))
        at_steady = jnp.logical_and(
            jnp.all(state.r - state.rs == 0.0), jnp.all(v - state.vs == 0.0)
        )
        return jnp.logical_or(
            jnp.logical_and(bool(c.limit_pde_state_size), blown), at_steady
        )
