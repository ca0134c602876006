"""Gymnasium adapter: the reference's imperative API over the functional core.

These classes reproduce the constructor kwargs, observation/action spaces and
5-tuple/2-tuple step/reset semantics of the reference envs
(``src/environments1d/hyperbolic.py``, ``parabolic.py``), so scripts written
against lukebhan/PDEControlGym run unmodified — while every hot sub-step loop
executes as a single jitted device program.

Reward plug-ins: the batched reward classes (rewards/) are used directly.
Legacy reward objects exposing the reference ABC signature
``reward(uVec, time_index, terminate, truncate, action)``
(``base_reward.py:13``) are also supported: the adapter then materializes the
reference-style ``(nt, state_dim)`` history buffer on the host (rows beyond
``time_index`` stay zero, exactly like the reference's preallocated buffer) and
calls the legacy object after each jitted step.
"""

from __future__ import annotations

from typing import Callable, Optional, Type

import gymnasium as gym
import numpy as np
from gymnasium import spaces

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_jax.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.base import BaseReward
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def _is_legacy_reward(reward) -> bool:
    return callable(getattr(reward, "reward", None)) and not isinstance(
        reward, BaseReward
    )


class _ZeroReward(BaseReward):
    """In-jit placeholder when the real reward runs host-side (legacy mode)."""

    @property
    def ring_requirement(self):
        return 1

    def __call__(self, ctx):
        return jnp.zeros((), ctx.u.dtype)


class Boundary1DGymEnv(gym.Env):
    """Shared Gymnasium wrapper for the 1D boundary-control family."""

    functional_cls = None
    config_cls = Boundary1DConfig
    default_control_sample_rate = 0.1  # hyperbolic.py:34 / parabolic.py:34

    def __init__(
        self,
        sensing_noise_func: Callable = None,
        reset_init_condition_func: Callable = None,
        reset_recirculation_func: Callable = None,
        sensing_loc: str = "full",
        control_type: str = "Dirchilet",
        sensing_type: str = "Dirchilet",
        limit_pde_state_size: bool = False,
        max_state_value: float = 1e10,
        max_control_value: float = 20,
        control_sample_rate: float = None,
        T: float = 5.0,
        dt: float = 1e-4,
        X: float = 1.0,
        dx: float = 1e-2,
        reward_class: Type[BaseReward] = None,
        normalize: bool = False,
        **extra_config,
    ):
        super().__init__()
        self.sensing_noise_func = sensing_noise_func or (lambda s: s)
        self.reset_init_condition_func = reset_init_condition_func
        self.reset_recirculation_func = reset_recirculation_func

        if control_sample_rate is None:
            control_sample_rate = self.default_control_sample_rate
        cfg = self.config_cls(
            T=T,
            dt=dt,
            X=X,
            dx=dx,
            sensing_loc=sensing_loc,
            control_type=control_type,
            sensing_type=sensing_type,
            limit_pde_state_size=limit_pde_state_size,
            max_state_value=max_state_value,
            max_control_value=max_control_value,
            control_sample_rate=control_sample_rate,
            normalize=normalize,
            **extra_config,
        )
        self.config = cfg
        self._legacy_reward = _is_legacy_reward(reward_class)
        if reward_class is None:
            reward_class = TunedReward1D(int(round(T / dt)))
        self.reward_class = reward_class
        env_reward = _ZeroReward() if self._legacy_reward else reward_class
        self.fenv = self.functional_cls(cfg, env_reward)

        # Mirror of the reference's public attributes (base_env_1d.py:23-28).
        self.nt = cfg.nt
        self.nx = cfg.nx
        self.dt, self.T, self.dx, self.X = dt, T, dx, X
        self.time_index = 0

        obs_dim = self.fenv.obs_dim
        self.observation_space = spaces.Box(
            np.full(obs_dim, -max_state_value, dtype="float32"),
            np.full(obs_dim, max_state_value, dtype="float32"),
        )
        self.action_space = spaces.Box(
            np.full(1, -1, dtype="float32"), np.full(1, 1, dtype="float32")
        )

        self._jit_init = jax.jit(self.fenv.init_from)
        # The adapter maintains the reference-style (nt, n) sub-step history
        # buffer `u` — reference users read env.u for plotting (e.g. the
        # notebook surface plots) and legacy rewards index it every step.
        # Fast path (native rewards): the buffer lives ON DEVICE and is
        # updated inside the jitted step, so the per-step host transfer is
        # just the observation — reading back the (S, n) interval rows
        # every step would cost a device-to-host copy the caller rarely
        # needs. `env.u` is a property that reads the device buffer back
        # only when actually accessed.
        # Legacy-reward mode keeps the host-side buffer: the reward object
        # indexes the numpy history after every step anyway.
        self._jit_step_hist = jax.jit(self._step_hist)
        self._host_history = self._legacy_reward
        self._jit_step_dev = jax.jit(self._step_dev, donate_argnums=2)
        self._state = None
        self._ubuf = None
        self._u_cache = None
        self.u = np.zeros((self.nt, self.fenv.state_dim), dtype=np.float32)

    @staticmethod
    def _pack(out, new_state):
        """Pack obs + (reward, terminated, truncated, time_index) into ONE
        f32 vector: every separate host read (float()/bool()/np.asarray)
        waits for the device and copies, so one read replaces five.
        time_index ≤ nt ≪ 2²⁴ is exact in f32."""
        return jnp.concatenate([
            jnp.asarray(out.obs, jnp.float32).reshape(-1),
            jnp.stack([
                jnp.asarray(out.reward, jnp.float32),
                out.terminated.astype(jnp.float32),
                out.truncated.astype(jnp.float32),
                new_state.time_index.astype(jnp.float32),
            ]),
        ])

    def _step_hist(self, state, action):
        new_state, out, rows = self.fenv.step_with_history(state, action)
        return new_state, self._pack(out, new_state), rows

    def _step_dev(self, state, action, ubuf):
        """Jitted step that also advances the device-resident history buffer.

        ``ubuf`` has ``S`` margin rows past ``nt``: on a partial (terminal)
        interval the frozen tail rows of the interval land in the margin
        (``dynamic_update_slice`` start = time_index+1 ≤ nt never clamps), so
        no per-row masking is needed; ``env.u`` exposes ``ubuf[:nt]``.
        """
        new_state, out, rows = self.fenv.step_with_history(state, action)
        ubuf = jax.lax.dynamic_update_slice(
            ubuf, rows, (state.time_index + 1, jnp.int32(0))
        )
        return new_state, self._pack(out, new_state), ubuf

    @property
    def u(self):
        if self._host_history or self._ubuf is None:
            return self._u_host
        # a WRITABLE host copy, cached between steps: repeated reads return
        # the same mutable array (reference users index and mutate env.u);
        # the next step/reset refreshes it from the device buffer, which is
        # the one documented divergence — user writes to PAST rows do not
        # survive an env step (the reference itself only ever appends rows)
        if self._u_cache is None:
            self._u_cache = np.array(self._ubuf[: self.nt])
        return self._u_cache

    @u.setter
    def u(self, value):
        # keep plain assignment working (reference users own `env.u`)
        self._u_host = np.asarray(value)
        self._u_cache = None
        if not self._host_history and self._ubuf is not None:
            S = self.config.sample_rate
            buf = jnp.zeros((self.nt + S, self.fenv.state_dim),
                            self.config.dtype)
            self._ubuf = buf.at[: self._u_host.shape[0]].set(
                jnp.asarray(self._u_host, self.config.dtype)
            )

    @property
    def state_dim(self) -> int:
        return self.fenv.state_dim

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        try:
            init_condition = self.reset_init_condition_func(self.nx)
            beta = self.reset_recirculation_func(self.nx)
        except Exception:
            raise Exception(
                "Please pass both an initial condition and a recirculation "
                "function in the parameters dictionary. See documentation for "
                "more details"
            )
        self._state, obs = self._jit_init(
            jnp.asarray(init_condition, jnp.float32), jnp.asarray(beta, jnp.float32)
        )
        self.time_index = 0
        if self._host_history:
            self.u = np.zeros((self.nt, self.fenv.state_dim), dtype=np.float32)
            self._u_host[0] = np.asarray(self._state.u)
        else:
            S = self.config.sample_rate
            self._ubuf = jnp.zeros(
                (self.nt + S, self.fenv.state_dim), self.config.dtype
            ).at[0].set(self._state.u)
            self._u_cache = None
        return self.sensing_noise_func(np.asarray(obs)), {}

    def step(self, control):
        control = np.asarray(control, dtype=np.float32).reshape(-1)[0]
        prev_t = self.time_index
        if self._host_history:
            self._state, packed, rows = self._jit_step_hist(self._state, control)
        else:
            self._state, packed, self._ubuf = self._jit_step_dev(
                self._state, control, self._ubuf
            )
            self._u_cache = None  # next env.u access re-reads the device buffer
        vec = np.asarray(packed)  # the ONE host read of this step
        obs = self.sensing_noise_func(vec[:-4])
        reward = float(vec[-4])
        terminate = bool(vec[-3])
        truncate = bool(vec[-2])
        self.time_index = int(vec[-1])
        if self._host_history:
            executed = self.time_index - prev_t
            if executed:
                self._u_host[prev_t + 1 : prev_t + 1 + executed] = (
                    np.asarray(rows)[:executed]
                )
        if self._legacy_reward:
            reward = self.reward_class.reward(
                self.u, self.time_index, terminate, truncate,
                self.u[self.time_index][-1],
            )
        return obs, reward, terminate, truncate, {}

    def terminate(self):
        return self.time_index >= self.nt - 1

    def truncate(self):
        return bool(
            self.config.limit_pde_state_size
            and np.linalg.norm(np.asarray(self._state.u), 2)
            >= self.config.max_state_value
        )


class TransportPDE1D(Boundary1DGymEnv):
    """Gymnasium-facing 1D transport env (API parity with ``hyperbolic.py:8``)."""

    functional_cls = TransportEnv


class ReactionDiffusionPDE1D(Boundary1DGymEnv):
    """Gymnasium-facing 1D reaction-diffusion env (parity with ``parabolic.py:8``).

    Extra kwargs (not in the reference): ``scheme`` ("explicit"|"implicit") and ``theta``.
    The reset IC callable receives ``nx`` and must return ``nx+1`` values
    (ghost-point grid), exactly as in the reference examples
    (``reactionDiffusion1DBackstepping.py:42-48``).
    """

    functional_cls = ReactionDiffusionEnv
    config_cls = ReactionDiffusionConfig
    default_control_sample_rate = 1e-4


class TrafficPDE1D(gym.Env):
    """Gymnasium-facing ARZ traffic env (API parity with ``traffic_arz_env.py:8``).

    Exposes the attributes the reference tutorial's backstepping controller
    reads (``docs/source/tutorials/Trafficarz1d_tutorial.rst:160-186``):
    ``qs, vs, rs, vm, rm, ps, tau, L, dx, v, r, simulation_type``.
    """

    def __init__(
        self,
        simulation_type: str = "inlet",
        v_steady: float = 10,
        ro_steady: float = 0.12,
        v_max: float = 40,
        ro_max: float = 0.16,
        tau: float = 60,
        limit_pde_state_size: bool = False,
        control_freq: int = 1,
        T: float = 240.0,
        dt: float = 0.25,
        X: float = 500.0,
        dx: float = 10.0,
        reward_class=None,
        normalize: bool = False,
        verbose: bool = True,
        seed: int = 0,
    ):
        super().__init__()
        if not (isinstance(control_freq, int) and control_freq >= 1):
            raise AssertionError(
                f"control_freq must be a positive integer (got {control_freq} "
                f"of type {type(control_freq).__name__})"
            )
        from pdecontrolgym_jax.rewards.traffic import TrafficARZReward

        reward = reward_class or TrafficARZReward()
        self._legacy_reward = _is_legacy_reward(reward) and not isinstance(
            reward, TrafficARZReward
        )
        cfg = TrafficARZConfig(
            T=T, dt=dt, X=X, dx=dx,
            simulation_type=simulation_type,
            v_steady=v_steady, ro_steady=ro_steady,
            v_max=v_max, ro_max=ro_max, tau=tau,
            limit_pde_state_size=limit_pde_state_size,
            control_freq=control_freq, normalize=normalize,
        )
        self.config = cfg
        env_reward = TrafficARZReward() if self._legacy_reward else reward
        self.reward_class = reward
        self.fenv = TrafficARZEnv(cfg, env_reward)

        banners = {
            "outlet": "Case 1: Outlet Boundary Control",
            "inlet": "Case 2: Inlet Boundary Control",
            "both": "Case 3: Outlet & Inlet Boundary Control",
            "inlet-train": "Case 4: Inlet training",
            "outlet-train": "Case 5: Outlet training",
        }
        if verbose:
            print(banners[simulation_type])

        # public attributes mirroring the reference (traffic_arz_env.py:36-88)
        self.simulation_type = simulation_type
        self.vm, self.rm = v_max, ro_max
        self.qm = v_max * ro_max / 4
        self.tau = tau
        self.T, self.dt, self.X, self.dx = T, dt, X, dx
        self.L = X
        self.M = cfg.M
        self.nt = int(round(T / dt) + 1)
        self.nx = int(round(X / dx))
        rs, vs, qs = cfg.nominal_steady()
        self.rs, self.vs, self.qs = rs, vs, qs
        self.ps = self.fenv.ps
        self.qs_input = np.linspace(qs / 2, 2 * qs, 40)  # traffic_arz_env.py:78
        if verbose:
            print("Steady state density, velocity: ", self.rs, ",", self.vs)

        if simulation_type == "outlet-train":
            self.observation_space = spaces.Box(
                low=-10, high=10, shape=(2 * self.M,), dtype=np.float64
            )
        else:
            self.observation_space = spaces.Box(
                low=0, high=40, shape=(2 * self.M,), dtype=np.float64
            )
        adim = 2 if simulation_type == "both" else 1
        self.action_space = spaces.Box(
            dtype=np.float64, low=qs * 0.8, high=1.2 * qs, shape=(adim,)
        )

        self._key = jax.random.key(seed)
        self._jit_init = jax.jit(self.fenv.init)
        self._jit_step = jax.jit(self._step_packed)
        self._state, obs = self._jit_init(self._next_key())
        self.time_index = 0
        self.info = {"V": np.asarray(self.fenv._velocity(self._state)).reshape(-1, 1)}

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _step_packed(self, state, action):
        """One packed host read per step (obs ‖ v ‖ reward/term/trunc/time):
        each separate float()/bool()/np.asarray is its own device sync and
        copy."""
        new_state, out = self.fenv.step(state, action)
        v = self.fenv._velocity(new_state)
        w = jnp.result_type(out.obs.dtype, new_state.time_index.dtype)
        tail = jnp.stack([
            out.reward.astype(w),
            out.terminated.astype(w),
            out.truncated.astype(w),
            new_state.time_index.astype(w),
        ])
        return new_state, jnp.concatenate(
            [out.obs.astype(w), v.astype(w), tail]
        )

    @property
    def r(self):
        return np.asarray(self._state.r).reshape(-1, 1)

    @property
    def v(self):
        return np.asarray(self.fenv._velocity(self._state)).reshape(-1, 1)

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.key(seed)
        self._state, obs = self._jit_init(self._next_key())
        if self.config.is_train:
            self.rs = float(self._state.rs)
            self.vs = float(self._state.vs)
            self.qs = float(self._state.qs)
        self.time_index = 0
        return np.asarray(obs, np.float64), {}

    def step(self, action):
        self._state, packed = self._jit_step(
            self._state, jnp.asarray(np.asarray(action, np.float64).reshape(-1))
        )
        vec = np.asarray(packed, np.float64)  # the ONE host read
        nobs = 2 * self.M
        obs = vec[:nobs]
        v = vec[nobs:nobs + self.M]
        reward = float(vec[-4])
        terminated = bool(vec[-3])
        truncated = bool(vec[-2])
        self.time_index = float(vec[-1])
        if self._legacy_reward:
            reward = float(
                self.reward_class.reward(self.vs, self.rs, self.v, self.r)
            )
            # the reference's early stop compares the USER's reward value
            # (traffic_arz_env.py:233); re-derive termination from the time
            # condition (which zeroes time_index, :110) + the legacy reward
            if self.simulation_type != "outlet-train":
                time_terminated = self.time_index == 0.0
                terminated = (
                    time_terminated or reward > self.config.early_stop_threshold
                )
        return (
            obs,
            reward,
            terminated,
            truncated,
            {"V": v.reshape(-1, 1)},
        )


class NeuronPDE1D(gym.Env):
    """Gymnasium-facing neuron growth env.

    The reference version (``neuron_env.py:8``) is unregistered and its
    ``step()`` is unrunnable (latent ``atilde1`` AttributeError); this adapter
    exposes the fixed dynamics. ``step()`` ignores the action — the
    backstepping controller is embedded in the environment — and the
    observation is the state truncated to the moving boundary ``u[:L]``
    (dynamic length, like the reference's ``new_u``).
    """

    def __init__(
        self,
        sensing_noise_func: Callable = None,
        limit_pde_state_size: bool = False,
        max_state_value: float = 1e10,
        max_control_value: float = 20,
        control_type: str = "Neumann",
        sensing_type: str = "Neumann",
        sensing_loc: str = "full",
        T: float = 180.0,
        dt: float = 5e-6,
        X: float = 12e-6,
        dx: float = 0.01,
        reward_class=None,
        normalize: bool = False,
        **physical_params,
    ):
        super().__init__()
        from pdecontrolgym_jax.envs.neuron import NeuronConfig, NeuronEnv

        cfg = NeuronConfig(
            T=T, dt=dt, X=X, dx=dx,
            limit_pde_state_size=limit_pde_state_size,
            max_state_value=max_state_value,
            max_control_value=max_control_value,
            control_type=control_type,
            sensing_type=sensing_type,
            sensing_loc=sensing_loc,
            normalize=normalize,
            **physical_params,
        )
        self.config = cfg
        self.sensing_noise_func = sensing_noise_func or (lambda s: s)
        self.fenv = NeuronEnv(cfg, reward_class if not _is_legacy_reward(reward_class) else None)
        self._legacy_reward = _is_legacy_reward(reward_class)
        self.reward_class = reward_class
        self.M = self.fenv.M
        self.nt, self.dt, self.T, self.dx, self.X = cfg.nt, dt, T, dx, X
        # scalar sensing variants (collocated/opposite) observe 1 value; only
        # "full" returns the state row, truncated to u[:L] on the host below
        # (the reference's dynamic-length new_u, neuron_env.py:325-331)
        self._full_sensing = cfg.sensing_loc == "full"
        obs_dim = self.fenv.obs_dim
        # dtype follows the env (f64 default; f32 when x64 is off) so obs are
        # IN the declared space — the gymnasium check_env contract
        obs_dt = np.dtype(jnp.zeros((), cfg.dtype).dtype)
        self.observation_space = spaces.Box(
            np.full(obs_dim, -max_state_value, dtype=obs_dt),
            np.full(obs_dim, max_state_value, dtype=obs_dt),
            dtype=obs_dt,
        )
        self.action_space = spaces.Box(
            low=np.array([-max_control_value], dtype="float32"),
            high=np.array([max_control_value], dtype="float32"),
            shape=(1,), dtype="float32",
        )
        self._jit_init = jax.jit(self.fenv.init)
        self._jit_step = jax.jit(self._step_packed)
        self._state = None
        self.time_index = 0.0

    def _step_packed(self, state):
        """One packed host read per step (docs/PERFORMANCE.md item 14)."""
        new_state, out = self.fenv.step(state)
        w = jnp.result_type(out.obs.dtype, new_state.time_index.dtype)
        tail = jnp.stack([
            out.reward.astype(w),
            out.terminated.astype(w),
            out.truncated.astype(w),
            out.info["L"].astype(w),  # exact in f32: L <= M << 2^24
            new_state.time_index.astype(w),
        ])
        return new_state, jnp.concatenate([out.obs.reshape(-1).astype(w), tail])

    @property
    def L(self):
        return int(self._state.L)

    @property
    def u(self):
        return np.asarray(self._state.u).reshape(-1, 1)

    @property
    def Z(self):
        return np.asarray(self._state.Z).reshape(-1, 1)

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        self._state, obs = self._jit_init(None)
        self.time_index = 0.0
        obs = np.asarray(obs)
        if self._full_sensing:
            obs = obs[: self.L]
        return self.sensing_noise_func(obs), {}

    def step(self, action=None):
        self._state, packed = self._jit_step(self._state)
        vec = np.asarray(packed)  # the ONE host read
        obs = vec[:-5]
        reward = float(vec[-5])
        terminated = bool(vec[-4])
        truncated = bool(vec[-3])
        L = int(vec[-2])
        self.time_index = float(vec[-1])
        if self._full_sensing:
            obs = obs[:L]
        obs = self.sensing_noise_func(obs)
        if self._legacy_reward and self.reward_class is not None:
            # full sensing: the packed obs segment already IS the state row —
            # reading self._state.u would be a second device read
            row = vec[:-5] if self._full_sensing else np.asarray(self._state.u)
            u2d = row.reshape(-1, 1)
            reward = self.reward_class.reward(
                u2d, self.time_index, terminated, truncated, u2d[L],
            )
        return obs, reward, terminated, truncated, {}


class BrainTumor1D(gym.Env):
    """Gymnasium-facing glioblastoma env (API parity with
    ``brain_tumor_env.py:8``), including the recorded-metrics attributes the
    notebook reads (``cDeathDay``, ``t_benchmark``, ``simulationDays``,
    ``stage``, ``t1_radius_idx_vs_time``, ``dosage_vs_time``)."""

    def __init__(
        self,
        t1_detection_threshold: float = 0.8,
        t2_detection_threshold: float = 0.16,
        dosage_termination_threshold: float = 0.1,
        D: float = 0.2,
        rho: float = 0.03,
        alpha: float = 0.04,
        alpha_beta_ratio: float = 10,
        k: float = 1e5,
        t1_detection_radius: float = 15,
        t1_death_radius: float = 35,
        reset_init_condition_func: Callable = None,
        total_dosage: float = None,
        verbose: bool = True,
        T: float = 600.0,
        dt: float = 1.0,
        X: float = 200.0,
        dx: float = 1.0,
        reward_class=None,
        normalize: bool = False,
    ):
        super().__init__()
        from pdecontrolgym_jax.envs.brain_tumor import (
            STAGE_NAMES,
            BrainTumorConfig,
            BrainTumorEnv,
        )
        from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward

        self.verbose = verbose
        cfg = BrainTumorConfig(
            T=T, dt=dt, X=X, dx=dx,
            t1_detection_threshold=t1_detection_threshold,
            t2_detection_threshold=t2_detection_threshold,
            dosage_termination_threshold=dosage_termination_threshold,
            D=D, rho=rho, alpha=alpha, alpha_beta_ratio=alpha_beta_ratio, k=k,
            t1_detection_radius=t1_detection_radius,
            t1_death_radius=t1_death_radius,
            total_dosage=float(total_dosage),
            normalize=normalize,
        )
        self.config = cfg
        reward = reward_class or BrainTumorReward()
        self._legacy_reward = _is_legacy_reward(reward) and not isinstance(
            reward, BrainTumorReward
        )
        env_reward = BrainTumorReward() if self._legacy_reward else reward
        self.reward_class = reward
        self.fenv = BrainTumorEnv(cfg, env_reward)
        self._stage_names = STAGE_NAMES
        self.reset_init_condition_func = reset_init_condition_func

        self.nt, self.nx = cfg.nt, cfg.nx
        self.dt, self.T, self.dx, self.X = dt, T, dx, X
        self.total_dosage = float(total_dosage)
        self.xScale = np.linspace(0, X, cfg.nx)
        if verbose:
            print(f"nx: {self.nx}, nt: {self.nt}")
            print(f"u.shape: {(self.nt, self.nx)}")

        self.action_space = spaces.Box(
            np.full(1, 0, dtype="float32"), np.full(1, 1, dtype="float32")
        )
        self.observation_space = spaces.Box(
            np.full(cfg.nx, 0, dtype="float64"),
            np.full(cfg.nx, k, dtype="float64"),
            dtype=np.float64,
        )

        self._jit_init = jax.jit(self.fenv.init_from)
        self._jit_step = jax.jit(self._step_packed)
        self._state = None
        self._t_benchmark = None
        self._stage_cache = None
        self.u = np.zeros((cfg.nt, cfg.nx))
        self.t1_radius_idx_vs_time = np.zeros(cfg.nt)
        self.dosage_vs_time = np.zeros(cfg.nt)
        self.time_index = 0

    def _step_packed(self, state, control):
        """One packed host read per step: the previous version made ~9
        separate reads (obs, reward, flags, time, stage, two dosage reads and
        an extra tumor_radius dispatch), each its own device sync — and
        TherapyWrapper loops whole stages through step()."""
        new_state, out = self.fenv.step(state, control)
        t1, has = self.fenv.tumor_radius(
            new_state.u, self.config.t1_detection_threshold
        )
        dose_delta = state.remaining_dosage - new_state.remaining_dosage
        w = jnp.result_type(out.obs.dtype, jnp.float32)
        tail = jnp.stack([
            out.reward.astype(w),
            out.terminated.astype(w),
            out.truncated.astype(w),
            new_state.time_index.astype(w),
            t1.astype(w),
            has.astype(w),
            dose_delta.astype(w),
            new_state.stage.astype(w),
        ])
        return new_state, jnp.concatenate([out.obs.astype(w), tail])

    # -- recorded metrics (reference attribute names) -------------------------

    @property
    def stage(self):
        # cached from the packed step read; TherapyWrapper polls this between
        # host steps, so an uncached device read would double the round trips
        if self._stage_cache is not None:
            return self._stage_names[self._stage_cache]
        return self._stage_names[int(self._state.stage)] if self._state is not None else "Growth"

    @property
    def t_benchmark(self):
        return self._t_benchmark

    @t_benchmark.setter
    def t_benchmark(self, value):
        self._t_benchmark = value
        if self._state is not None and value is not None:
            self._state = self._state.replace(
                t_benchmark=jnp.asarray(int(value), jnp.int32)
            )

    @property
    def simulationDays(self):
        return int(self._state.simulation_days)

    @property
    def growthDays(self):
        return int(self._state.growth_days)

    @property
    def therapyDays(self):
        return int(self._state.therapy_days)

    @property
    def postTherapyDays(self):
        return int(self._state.post_therapy_days)

    @property
    def firstTherapyDay(self):
        d = int(self._state.first_therapy_day)
        return None if d < 0 else d

    @property
    def firstPostTherapyDay(self):
        d = int(self._state.first_post_therapy_day)
        return None if d < 0 else d

    @property
    def cDeathDay(self):
        d = int(self._state.death_day)
        return None if d < 0 else d

    @property
    def remaining_dosage(self):
        return float(self._state.remaining_dosage)

    @property
    def u_current(self):
        return np.asarray(self._state.u)

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        try:
            init_condition = self.reset_init_condition_func(self.X, self.nx)
        except Exception:
            raise Exception("Please pass an initial condition function")
        tb = None if self._t_benchmark is None else int(self._t_benchmark)
        self._state, obs = self._jit_init(jnp.asarray(init_condition), tb)
        self.time_index = 0
        self._stage_cache = 0  # reset always starts in Growth
        # reference-style (nt, nx) density history (brain_tumor_env.py:365)
        self.u = np.zeros((self.nt, self.nx))
        self.u[0] = np.asarray(obs)
        self.t1_radius_idx_vs_time = np.zeros(self.nt)
        self.t1_radius_idx_vs_time[0] = np.nan
        self.dosage_vs_time = np.zeros(self.nt)
        # f64 cast matches the declared Box dtype (step() already emits f64
        # via the packed read) — check_env flags a reset/space dtype mismatch
        return np.asarray(obs, np.float64), {}

    def step(self, control):
        control = float(np.asarray(control, np.float64).reshape(-1)[0])
        self._state, packed = self._jit_step(self._state, jnp.float32(control))
        vec = np.asarray(packed, np.float64)  # the ONE host read
        obs = vec[:-8]
        reward = float(vec[-8])
        terminated = bool(vec[-7])
        truncated = bool(vec[-6])
        self.time_index = int(vec[-5])
        t1, has = vec[-4], bool(vec[-3])
        self._stage_cache = int(vec[-1])
        self.u[self.time_index] = obs
        self.t1_radius_idx_vs_time[self.time_index] = (
            t1 / self.dx if has else np.nan
        )
        self.dosage_vs_time[self.time_index] = vec[-2]
        return (
            obs,
            reward,
            terminated,
            truncated,
            {"stage": self.stage},
        )


class TherapyWrapper(gym.Wrapper):
    """Host-side port of the reference ``TherapyWrapper``
    (``brain_tumor_env.py:386-506``): hides Growth inside ``reset`` and
    Post-Therapy inside one ``step``; optional weekend breaks; ``benchmark()``
    runs the zero-treatment baseline and stores ``t_benchmark``."""

    def __init__(self, env, weekends: bool = False, verbose: bool = True):
        super().__init__(env)
        self.verbose = verbose
        self.weekends = weekends
        self.treatment_calls = 0
        self.soft_constraint_violations = 0
        self.consecutive_treatment_days = 0

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        # NOT super().reset(): gym.Wrapper.reset fully delegates to env.reset,
        # which would reset the wrapped env twice and discard the seeded one
        self.consecutive_treatment_days = 0
        obs, info = self.env.reset(seed=seed)
        while self.env.unwrapped.stage == "Growth":
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                break
        return obs, info

    def step(self, control):
        if self.env.unwrapped.stage == "Post-Therapy":
            terminated, truncated = False, False
            while not (terminated or truncated):
                obs, reward, terminated, truncated, info = self.env.step(0)
            return obs, reward, terminated, truncated, info

        obs, reward, terminated, truncated, info = self.env.step(control)
        self.treatment_calls += 1
        if reward < 0.0:
            self.soft_constraint_violations += 1

        if self.weekends:
            control_val = float(np.asarray(control).reshape(-1)[0]) if np.ndim(control) else float(control)
            if control_val > 0:
                self.consecutive_treatment_days += 1
            else:
                self.consecutive_treatment_days = 0
            if self.consecutive_treatment_days >= 5:
                self.consecutive_treatment_days = 0
                for _ in range(2):
                    self.env.step(0)
                    if terminated or truncated:
                        return obs, reward, terminated, truncated, info
        return obs, reward, terminated, truncated, info

    def benchmark(self):
        obs, info = self.env.reset()
        terminated = truncated = False
        while not (terminated or truncated):
            obs, _, terminated, truncated, info = self.env.step(0)
        t_benchmark = self.env.unwrapped.simulationDays
        self.env.unwrapped.t_benchmark = t_benchmark
        obs, info = self.env.reset()
        return t_benchmark


class NavierStokes2D(gym.Env):
    """Gymnasium-facing 2D Navier-Stokes env (API parity with
    ``navier_stokes2D.py:24``). Exposes the attributes/methods the reference
    examples rely on: ``u, v, p, U`` (episode history), ``solve_pressure``,
    the meshgrid ``X``/``Y``, and reset via ``reset_init_condition_func(X)``.
    """

    def __init__(
        self,
        reset_init_condition_func: Callable = None,
        boundary_condition: dict = None,
        U_ref=None,
        action_ref=None,
        viscosity: float = 0.1,
        density: float = 1.0,
        maximum_pressure_iteration: int = 2000,
        stable_factor: float = 0.5,
        T: float = 0.2,
        dt: float = 1e-3,
        X: float = 1.0,
        dx: float = 0.05,
        Y: float = 1.0,
        dy: float = 0.05,
        action_dim: int = 1,
        reward_class=None,
        normalize: bool = False,
        # additive kwargs (reference signature ends above; defaults
        # reproduce the reference's f64 Jacobi exactly). pressure_solver
        # "direct"/"matpow" + dtype np.float32 unlock the fast paths
        # (docs/ENVIRONMENTS.md "NavierStokes2D") through the same adapter.
        pressure_solver: str = "jacobi",
        pressure_layout: str = "grid",
        dtype=None,
    ):
        super().__init__()
        from pdecontrolgym_jax.rewards.ns import NSReward

        self.reset_init_condition_func = reset_init_condition_func
        bc = freeze_boundary_condition(
            boundary_condition
            if boundary_condition is not None
            else {
                "upper": ["Controllable", "Dirchilet"],
                "lower": ["Dirchilet", "Dirchilet"],
                "left": ["Dirchilet", "Dirchilet"],
                "right": ["Dirchilet", "Dirchilet"],
            }
        )
        cfg_kw = {}
        if dtype is not None:
            import jax.numpy as _jnp

            cfg_kw["dtype"] = _jnp.dtype(dtype).type
        cfg = NavierStokesConfig(
            T=T, dt=dt, X=X, dx=dx, Y=Y, dy=dy,
            action_dim=action_dim,
            viscosity=viscosity, density=density,
            maximum_pressure_iteration=int(maximum_pressure_iteration),
            stable_factor=stable_factor,
            normalize=normalize,
            boundary_condition=bc,
            pressure_solver=pressure_solver,
            pressure_layout=pressure_layout,
            **cfg_kw,
        )
        self.config = cfg
        reward = reward_class or NSReward(0.1)
        self._legacy_reward = _is_legacy_reward(reward) and not isinstance(
            reward, NSReward
        )
        if U_ref is None:
            U_ref = np.zeros((cfg.nt, cfg.nx, cfg.ny, 2))
        if action_ref is None:
            action_ref = np.zeros(cfg.nt)
        env_reward = NSReward(0.1) if self._legacy_reward else reward
        self.reward_class = reward
        self._U_ref_np = np.asarray(U_ref)
        self._action_ref_np = np.asarray(action_ref)
        self.fenv = NavierStokesEnv(cfg, env_reward, U_ref, action_ref)

        # reference public attributes (base_env_2d.py:26-51)
        self.nt, self.nx, self.ny = cfg.nt, cfg.nx, cfg.ny
        self.dt, self.dx, self.dy = dt, dx, dy
        self.x = np.linspace(0, X, cfg.nx)
        self.y = np.linspace(0, Y, cfg.ny)
        self.X, self.Y = np.meshgrid(self.x, self.y)  # meshgrid overwrite quirk
        # Box dtype follows the env dtype (f64 by default, f32 when x64 is
        # off or the config asks for it) so returned observations are IN the
        # declared space — gymnasium's check_env contract; the reference's
        # f32 Box vs f64 obs would fail its own imported checker.
        obs_dt = np.dtype(jnp.zeros((), cfg.dtype).dtype)
        # finite bounds (vs the reference's implicit unboundedness): velocity
        # fields that reach 1e10 have long since diverged — a ±inf Box trips
        # gymnasium's check_env bounds warning for no expressive gain
        self.observation_space = spaces.Box(
            np.full((cfg.nx, cfg.ny, 2), -1e10, dtype=obs_dt),
            np.full((cfg.nx, cfg.ny, 2), 1e10, dtype=obs_dt),
            dtype=obs_dt,
        )
        self.action_space = spaces.Box(
            low=-1.0, high=1.0, shape=(action_dim,), dtype=np.float32
        )
        self.U = np.zeros((cfg.nt, cfg.nx, cfg.ny, 2))
        self.time_index = 0
        self._jit_init = jax.jit(self.fenv.init_from)
        self._jit_step = jax.jit(self._step_packed)
        self._jit_pressure = jax.jit(self.fenv.solve_pressure)
        self._state = None

    def _step_packed(self, state, action):
        """One packed host read per step (docs/PERFORMANCE.md item 14)."""
        new_state, out = self.fenv.step(state, action)
        w = jnp.result_type(out.obs.dtype, jnp.float32)
        tail = jnp.stack([
            out.reward.astype(w),
            out.terminated.astype(w),
            new_state.time_index.astype(w),
        ])
        return new_state, jnp.concatenate([out.obs.reshape(-1).astype(w), tail])

    # state fields unpack from the carried layout (no-op unless the fused
    # kernel packs, which needs an explicit f32+direct config here)
    @property
    def u(self):
        return np.asarray(self.fenv._unpack(self._state.u))

    @property
    def v(self):
        return np.asarray(self.fenv._unpack(self._state.v))

    @property
    def p(self):
        return np.asarray(self.fenv._unpack(self._state.p))

    def solve_pressure(self, u, v, p_prev):
        """Generic fixed-iteration Poisson solve, reused by the adjoint
        optimization example (``NS2Doptimization.py:97``)."""
        return np.asarray(
            self._jit_pressure(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p_prev))
        )

    def terminate(self):
        return self.time_index >= self.nt - 1

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        super().reset(seed=seed)
        try:
            init_u, init_v, init_p = self.reset_init_condition_func(self.X)
        except Exception:
            raise Exception(
                "Please pass both an initial condition and a recirculation "
                "function in the parameters dictionary. See documentation for "
                "more details"
            )
        self._state, obs = self._jit_init(
            jnp.asarray(init_u), jnp.asarray(init_v), jnp.asarray(init_p)
        )
        self.time_index = 0
        self.U = np.zeros((self.nt, self.nx, self.ny, 2))
        self.U[0] = np.asarray(obs)
        return np.asarray(obs), {}

    def step(self, action):
        a = np.asarray(action, dtype=np.float64).reshape(-1)
        self._state, packed = self._jit_step(self._state, jnp.asarray(a))
        vec = np.asarray(packed)  # the ONE host read
        obs = vec[:-3].reshape(self.U.shape[1:])
        reward = float(vec[-3])
        terminate = bool(vec[-2])
        self.time_index = int(vec[-1])
        self.U[self.time_index] = obs
        if self._legacy_reward:
            reward = self.reward_class.reward(
                self.U, self.time_index, self._U_ref_np, a, self._action_ref_np
            )
        return obs, reward, terminate, False, {}


class BurgersPDE1D(Boundary1DGymEnv):
    """Gymnasium-facing 1D Burgers env (not in the reference; BASELINE
    config 2).

    Extra kwarg: ``viscosity``. The reset recirculation callable is unused by
    the dynamics (kept for API uniformity; pass ``lambda nx: np.zeros(nx)``).
    """

    functional_cls = BurgersEnv
    config_cls = BurgersConfig
    default_control_sample_rate = 0.01
