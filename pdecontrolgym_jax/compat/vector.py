"""Gymnasium VectorEnv adapter over the lockstep device batch.

The reference has no vectorized envs at all (SB3 drives one Python env,
SURVEY §2.3). This adapter exposes a functional env's batched/autoreset step
as a standard ``gymnasium.vector.VectorEnv``, so any library built on the
vector API (SB3's VecEnv shims, cleanrl loops, ...) can drive thousands of
device-resident envs with one process: each ``step`` call is a single jitted
program; only the observation/reward batch crosses the host boundary.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import gymnasium as gym
from gymnasium import spaces
from gymnasium.vector import VectorEnv

import jax
import jax.numpy as jnp


class PDEVectorEnv(VectorEnv):
    """Batched autoreset wrapper around a functional env.

    Autoreset is SAME-STEP: on the step where an episode ends, the returned
    observation is already the first observation of the next episode (the
    in-kernel autoreset of ``FunctionalEnv.autoreset_step``), declared via
    ``metadata["autoreset_mode"]`` so gymnasium 1.x consumers handle terminal
    transitions correctly.
    """

    def __init__(self, fenv, num_envs: int, seed: int = 0,
                 obs_low=-np.inf, obs_high=np.inf,
                 act_low=None, act_high=None):
        try:
            from gymnasium.vector import AutoresetMode

            self.metadata = {"autoreset_mode": AutoresetMode.SAME_STEP}
        except ImportError:  # older gymnasium without the enum
            self.metadata = {"autoreset_mode": "SameStep"}
        self.fenv = fenv
        self.num_envs = num_envs
        # derive the obs shape from the env itself (e.g. NS frames are
        # (ny, nx, 2), not the (nx, ny, 2) one might guess for nx != ny)
        obs_shape = jax.eval_shape(
            lambda k: fenv.init(k)[1], jax.random.key(0)
        ).shape
        adim = fenv.action_dim
        self.single_observation_space = spaces.Box(
            obs_low, obs_high, shape=obs_shape, dtype=np.float32
        )
        if act_low is None:
            act_low = getattr(fenv, "action_low", -1.0)
        if act_high is None:
            act_high = getattr(fenv, "action_high", 1.0)
        self.single_action_space = spaces.Box(
            act_low, act_high, shape=(adim,), dtype=np.float32
        )
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, num_envs
        )
        self.action_space = gym.vector.utils.batch_space(
            self.single_action_space, num_envs
        )
        self._key = jax.random.key(seed)

        self._jit_init = jax.jit(lambda keys: jax.vmap(fenv.init)(keys))
        from pdecontrolgym_jax.parallel.rollout import batch_step

        self._jit_step = jax.jit(batch_step(fenv, autoreset=True))
        self._state = None

    def _split(self, n=1):
        self._key, *sub = jax.random.split(self._key, n + 1)
        return sub[0] if n == 1 else sub

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._key = jax.random.key(seed)
        keys = jax.random.split(self._split(), self.num_envs)
        self._state, obs = self._jit_init(keys)
        return np.asarray(obs, np.float32), {}

    def step(self, actions):
        a = jnp.asarray(np.asarray(actions, np.float32))
        if a.ndim == 2 and self.fenv.action_dim == 1:
            a = a[:, 0]
        self._state, out = self._jit_step(self._state, a, self._split())
        return (
            np.asarray(out.obs, np.float32),
            np.asarray(out.reward, np.float32),
            np.asarray(out.terminated),
            np.asarray(out.truncated),
            {},
        )
