"""Functional env wrappers: observation/action adapters for MLP agents.

The reference relies on SB3 conventions (flattened Box observations,
unsquashed Gaussian actions clipped by the env). These wrappers provide the
same adaptations for the on-device trainers while staying pure-functional:
each delegates ``init``/``step`` and inherits the generic masked
``autoreset_step`` from :class:`~pdecontrolgym_jax.core.base.FunctionalEnv`.

Batched-path delegation: ``parallel/rollout.batch_step`` prefers an env's
``step_batch`` (e.g. the interval kernel) over per-env ``vmap(step)``, and
``_rollout_fixed_len`` keys off ``fixed_episode_length``/``observe_batch``.
A wrapper that hid those attributes silently demoted every wrapped env to
the vmap fallback — the NS training examples all wrap in ``FlatObsEnv``, so
the fused training path was unreachable (review finding). Each wrapper now
forwards the batched protocol when (and only when) the inner env provides
it, applying its own obs/action adaptation on the batched signature.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.core.base import FunctionalEnv


def _delegate_batch_protocol(wrapper, obs_map=None, act_map=None):
    """Forward the batched protocol (``step_batch`` / ``init_batch`` /
    ``observe_batch`` / ``fixed_episode_length`` / ``autoreset_gate``) from
    ``wrapper.env`` onto the wrapper instance, composing the wrapper's
    batched obs/action adaptation. Instance attributes (not class methods) so
    ``hasattr``/``getattr`` probes in ``parallel/rollout`` see exactly what
    the inner env supports — hiding any of these silently demotes the
    wrapped env to slower generic paths (e.g. TherapyEnv's forced
    ``autoreset_gate`` exists because its init fast-forwards a whole
    Growth stage; losing it re-runs that every rollout step)."""
    env = wrapper.env
    fixed_len = getattr(env, "fixed_episode_length", None)
    if fixed_len is not None:
        wrapper.fixed_episode_length = fixed_len
    gate = getattr(env, "autoreset_gate", None)
    if gate is not None:
        wrapper.autoreset_gate = gate
    if hasattr(env, "step_batch"):

        def step_batch(state, actions):
            if act_map is not None:
                actions = act_map(actions)
            state, out = env.step_batch(state, actions)
            if obs_map is not None:
                out = out.replace(obs=obs_map(out.obs))
            return state, out

        wrapper.step_batch = step_batch
    if hasattr(env, "init_batch"):

        def init_batch(keys):
            state, obs = env.init_batch(keys)
            if obs_map is not None:
                obs = obs_map(obs)
            return state, obs

        wrapper.init_batch = init_batch
    inner_observe = getattr(env, "observe_batch", None)
    if inner_observe is not None:
        if obs_map is None:
            wrapper.observe_batch = inner_observe
        else:
            wrapper.observe_batch = lambda state: obs_map(inner_observe(state))


class FlatObsEnv(FunctionalEnv):
    """Flattens multi-dimensional observations for MLP policies (the NS
    ``(ny, nx, 2)`` frames — the reference's SB3 MlpPolicy does the same
    flatten internally)."""

    def __init__(self, env):
        self.env = env
        self.action_dim = env.action_dim
        _delegate_batch_protocol(
            self, obs_map=lambda obs: obs.reshape(obs.shape[0], -1)
        )

    def init(self, key):
        state, obs = self.env.init(key)
        return state, obs.reshape(-1)

    def step(self, state, action, key=None):
        state, out = self.env.step(state, action, key)
        return state, out.replace(obs=out.obs.reshape(-1))


class TanhBoxActionEnv(FunctionalEnv):
    """Maps unbounded policy actions into a Box via tanh:
    ``a_env = low + (tanh(a) + 1)/2 · (high − low)``.

    Needed where the env's action box is far from the policy's O(1) output
    scale (the traffic flux box ``[0.8·q*, 1.2·q*]`` around q*≈1.44,
    ``traffic_arz_env.py:90-100``) — raw clipping there flatlines the
    gradient signal for most of the Gaussian's mass.
    """

    def __init__(self, env, low=None, high=None):
        self.env = env
        self.action_dim = env.action_dim
        self.low = float(env.action_low if low is None else low)
        self.high = float(env.action_high if high is None else high)
        _delegate_batch_protocol(self, act_map=self._map)

    def _map(self, a):
        return self.low + 0.5 * (jnp.tanh(a) + 1.0) * (self.high - self.low)

    def init(self, key):
        return self.env.init(key)

    def step(self, state, action, key=None):
        return self.env.step(state, self._map(action), key)


class TransformObsEnv(FunctionalEnv):
    """Applies a pure function to observations (e.g. evaluating a policy
    trained on the traffic ``outlet-train`` normalized deviations inside the
    raw-observation ``outlet`` mode, mirroring the tutorial's
    ``RLController`` normalization, ``Trafficarz1d_tutorial.rst:279-296``).

    ``fn`` receives ONE env's observation; batched paths apply it per-env
    via ``vmap``."""

    def __init__(self, env, fn):
        self.env = env
        self.action_dim = env.action_dim
        self.fn = fn
        _delegate_batch_protocol(self, obs_map=jax.vmap(fn))

    def init(self, key):
        state, obs = self.env.init(key)
        return state, self.fn(obs)

    def step(self, state, action, key=None):
        state, out = self.env.step(state, action, key)
        return state, out.replace(obs=self.fn(out.obs))
