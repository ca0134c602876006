"""Boundary-segmented rollout for fixed-episode-length envs (parallel/rollout).

NS declares ``fixed_episode_length = nt-1`` (it terminates at exactly nt-1
steps and never truncates), which routes ``rollout`` through
``_rollout_fixed_len``: plain scans between episode boundaries plus a full
re-init at each boundary, instead of per-step masked autoreset. These tests
pin (a) exact equality with the generic path inside the first episode,
(b) correct boundary semantics (terminated flag, fresh obs, episode restart)
across multiple episodes.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pdecontrolgym_jax.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_jax.parallel.rollout import rollout
from pdecontrolgym_jax.rewards.ns import NSReward

BC = freeze_boundary_condition({
    "upper": ["Controllable", "Dirchilet"],
    "lower": ["Dirchilet", "Dirchilet"],
    "left": ["Dirchilet", "Dirchilet"],
    "right": ["Dirchilet", "Dirchilet"],
})


def _env(nt_steps=6, n=12):
    d = 1.0 / (n - 1)
    cfg = NavierStokesConfig(
        T=nt_steps * 1e-3, dt=1e-3, X=1.0, dx=d, Y=1.0, dy=d,
        viscosity=0.02, dtype=jnp.float32, pressure_solver="direct",
        boundary_condition=BC,
    )
    env = NavierStokesEnv(
        cfg, NSReward(0.1),
        jnp.zeros((cfg.nt, cfg.ny, cfg.nx, 2), cfg.dtype),
        jnp.zeros(cfg.nt, cfg.dtype),
    )
    assert env.fixed_episode_length == cfg.nt - 1
    return env


def _policy(obs, key):
    # deterministic but obs- and key-dependent, so path divergence shows up
    return (obs.mean(axis=(1, 2, 3), keepdims=False)[:, None]
            + jax.random.uniform(key, (obs.shape[0], 1), jnp.float32))


class _NoFixedLen:
    """Same env without the fixed_episode_length declaration."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        if name == "fixed_episode_length":
            raise AttributeError(name)
        return getattr(self._env, name)


def test_matches_generic_path_within_first_episode():
    env = _env()
    L = env.fixed_episode_length
    key = jax.random.PRNGKey(7)
    (sf, of), outs_f = rollout(env, _policy, 5, L - 1, key)
    (sg, og), outs_g = rollout(_NoFixedLen(env), _policy, 5, L - 1, key)
    for a, b in ((sf.u, sg.u), (sf.v, sg.v), (sf.p, sg.p),
                 (of, og), (outs_f.obs, outs_g.obs),
                 (outs_f.reward, outs_g.reward)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_boundary_semantics_across_episodes():
    env = _env()
    L = env.fixed_episode_length
    steps = 2 * L + 2  # two full episodes + 2 steps into the third
    (state, obs), outs = rollout(env, _policy, 4, steps, jax.random.PRNGKey(3))

    term = np.asarray(outs.terminated)
    expected = np.zeros(steps, bool)
    expected[L - 1] = expected[2 * L - 1] = True
    np.testing.assert_array_equal(term.any(axis=1), expected)
    np.testing.assert_array_equal(term.all(axis=1), expected)

    # boundary out carries the FRESH obs: constant fields (the default NS IC
    # is per-env constant u,v), unlike a mid-episode frame
    b0 = np.asarray(outs.obs[L - 1])
    assert np.ptp(b0.reshape(4, -1, 2), axis=1).max() < 1e-6
    # episode restarts: time_index back to steps-into-third-episode
    np.testing.assert_array_equal(np.asarray(state.time_index), 2)
    assert np.isfinite(np.asarray(outs.reward)).all()


def test_trajectory_shapes_and_carry():
    env = _env()
    L = env.fixed_episode_length
    (state, obs), outs = rollout(env, _policy, 3, L, jax.random.PRNGKey(0))
    assert outs.obs.shape[0] == L and outs.reward.shape == (L, 3)
    # carry after the boundary step is the fresh state
    np.testing.assert_array_equal(np.asarray(state.time_index), 0)
    np.testing.assert_array_equal(np.asarray(obs), np.asarray(outs.obs[-1]))


def test_zero_length_rollout():
    """num_steps=0 routes to the generic scan and returns an empty stack
    (the segment loop would otherwise concatenate zero pieces and crash)."""
    env = _env()
    (state, obs), outs = rollout(env, _policy, 4, 0, jax.random.PRNGKey(0))
    assert outs.obs.shape[0] == 0
    assert obs.shape == (4,) + env.obs_shape


def test_generic_observe_path_matches_carried_obs_path():
    """The round-5 state-only-carry generic path (env declares
    observe_batch) must produce EXACTLY the same trajectory — rewards,
    flags, stacked obs, final obs — as the carried-obs path (observe_batch
    hidden), including across autoresets. Uses traffic (a truncating env
    whose episodes desynchronize) with a policy that CONSUMES obs values,
    so the recomputed observations are live, not dead-coded."""
    from pdecontrolgym_jax.envs.traffic_arz import (
        TrafficARZConfig, TrafficARZEnv)
    from pdecontrolgym_jax.rewards.traffic import TrafficARZReward

    cfg = TrafficARZConfig(T=2.0, simulation_type="outlet")
    env = TrafficARZEnv(cfg, TrafficARZReward())
    mid = 0.5 * (env.action_low + env.action_high)

    def policy(obs, _key):
        # obs-dependent actions: recomputed obs must match carried obs
        return mid * (1.0 + 0.01 * jnp.tanh(obs[..., 0]))

    key = jax.random.key(3)
    assert hasattr(env, "observe_batch")
    (s1, o1), outs1 = jax.jit(
        lambda k: rollout(env, policy, 8, 40, k))(key)

    class Hidden:
        """Proxy hiding observe_batch (same step/init/step_batch)."""

        def __getattr__(self, name):
            if name in ("observe_batch",):
                raise AttributeError(name)
            return getattr(env, name)

    hidden = Hidden()
    assert not hasattr(hidden, "observe_batch")
    (s2, o2), outs2 = jax.jit(
        lambda k: rollout(hidden, policy, 8, 40, k))(key)

    # the two paths compute the same function but XLA fuses the recomputed
    # obs into different surrounding ops (different fp association), and the
    # ~1-ulp action differences compound through the obs-feedback loop —
    # tight tolerance, not bitwise
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), **tol)
    np.testing.assert_allclose(np.asarray(outs1.obs),
                               np.asarray(outs2.obs), **tol)
    np.testing.assert_allclose(np.asarray(outs1.reward),
                               np.asarray(outs2.reward), **tol)
    np.testing.assert_array_equal(np.asarray(outs1.terminated),
                                  np.asarray(outs2.terminated))
    np.testing.assert_array_equal(np.asarray(outs1.truncated),
                                  np.asarray(outs2.truncated))
    for a, b in zip(jax.tree_util.tree_leaves(s1),
                    jax.tree_util.tree_leaves(s2)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), **tol)
