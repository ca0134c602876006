"""Regression tests for code-review findings."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.traffic import TrafficARZReward
from pdecontrolgym_jax.rewards.tuned import TunedReward1D

from reference_loader import load_reference_module


def test_pallas_handles_non_multiple_batch():
    cfg = Boundary1DConfig(T=0.02, dt=1e-4, X=1.0, dx=1.0 / 128,
                           control_sample_rate=0.01, backend="interpret")
    env = TransportEnv(cfg, TunedReward1D(200, lookback=5))
    B = 770  # not a multiple of the kernel's env tile
    keys = jax.random.split(jax.random.key(0), B)
    state, obs = jax.vmap(env.init)(keys)
    state, out = jax.jit(lambda s, a: env.step_batch(s, a))(state, jnp.zeros(B))
    assert out.obs.shape == (B, 128)


def test_pallas_interpret_batch_not_multiple_of_tile():
    # the grid must pad the batch up to whole tiles: floor-dividing it
    # (B // tb) would silently never compute the last partial tile
    cfg = Boundary1DConfig(T=0.02, dt=1e-4, X=1.0, dx=1.0 / 128,
                           control_sample_rate=0.01, backend="interpret")
    env = TransportEnv(cfg, TunedReward1D(200, lookback=5))
    B = 200  # not a multiple of the kernel's env tile
    keys = jax.random.split(jax.random.key(0), B)
    state, obs = jax.vmap(env.init)(keys)
    state, out = jax.jit(lambda s, a: env.step_batch(s, a))(
        state, jnp.full((B,), 0.3))

    xcfg = dataclasses.replace(cfg, backend="xla")
    xenv = TransportEnv(xcfg, TunedReward1D(200, lookback=5))
    xstate, _ = jax.vmap(xenv.init)(keys)
    xstate, xout = jax.jit(lambda s, a: xenv.step_batch(s, a))(
        xstate, jnp.full((B,), 0.3))

    assert np.all(np.isfinite(np.asarray(out.obs)))
    np.testing.assert_allclose(np.asarray(out.obs), np.asarray(xout.obs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.reward),
                               np.asarray(xout.reward), rtol=1e-5, atol=1e-5)


def test_traffic_non_divisible_grid_shapes_consistent():
    cfg = TrafficARZConfig(X=505.0, dx=10.0, simulation_type="outlet")
    env = TrafficARZEnv(cfg, TrafficARZReward())
    state, obs = env.init(None)
    assert state.r.shape[0] == cfg.M
    assert obs.shape == (2 * cfg.M,)
    # matches the reference arange convention
    assert cfg.M == len(np.arange(0.0, 505.0 + 10.0, 10.0))


def test_adapter_history_buffer_populated_without_legacy_reward():
    import gymnasium as gym
    import pdecontrolgym_jax  # noqa: F401

    env = gym.make(
        "PDEControlGym-TransportPDE1D",
        T=0.05, dt=1e-4, X=1.0, dx=1e-2,
        reward_class=TunedReward1D(500, -1e3, 3e2),
        normalize=False, sensing_loc="full", control_type="Dirchilet",
        sensing_type=None, sensing_noise_func=lambda s: s,
        limit_pde_state_size=True, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda n: np.ones(n, np.float32) * 2,
        reset_recirculation_func=lambda n: np.zeros(n, np.float32),
        control_sample_rate=0.01,
    ).unwrapped
    env.reset()
    env.step(np.float32(0.5))
    # all 100 sub-step rows of the first interval are filled
    assert np.abs(env.u[1:101]).sum() > 0
    assert np.allclose(env.u[100][-1], 0.5)  # boundary = control


def test_short_interval_lookback_matches_reference_zero_wrap():
    """sample_rate < lookback: the reference's uVec[t-100] wraps into unwritten
    zero rows; the trailing ring must reproduce that (review finding)."""
    parabolic = load_reference_module("pde_control_gym.src.environments1d.parabolic")
    tuned = load_reference_module("pde_control_gym.src.rewards.tuned_reward_1d")
    T, DT, DX = 0.01, 1e-5, 5e-3
    u0 = np.full(201, 2.0, np.float32)
    ref = parabolic.ReactionDiffusionPDE1D(
        T=T, dt=DT, X=1.0, dx=DX,
        reward_class=tuned.TunedReward1D(int(round(T / DT)), -1e3, 3e2),
        normalize=False, sensing_loc="full", control_type="Dirchilet",
        sensing_type="Neumann", sensing_noise_func=lambda s: s,
        limit_pde_state_size=False, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda nx: u0,
        reset_recirculation_func=lambda nx: np.zeros(nx + 1, np.float32),
        control_sample_rate=1e-4,  # S=10 sub-steps << lookback 100
    )
    ref.reset()

    from pdecontrolgym_jax.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )

    cfg = ReactionDiffusionConfig(
        T=T, dt=DT, X=1.0, dx=DX, control_sample_rate=1e-4,
    )
    env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(T / DT)), -1e3, 3e2))
    state, _ = env.init_from(u0, np.zeros(201, np.float32))
    step = jax.jit(env.step)
    # t goes 10, 20, ..., 120: the first 9 steps read pre-episode (zero) rows
    for i in range(12):
        robs, rrew, rterm, rtrunc, _ = ref.step(np.float32(0.1))
        state, out = step(state, jnp.float32(0.1))
        np.testing.assert_allclose(rrew, float(out.reward), rtol=2e-3, atol=2e-3)


def test_partial_terminal_interval_fallthrough_semantics():
    """Terminal interval that runs only half its sub-steps with ||u(T)|| >= 20:
    TunedReward falls through to the lookback difference (tuned_reward_1d.py:40).
    The engine must take the SAME branch as the reference (cur_norm is exact on
    partial intervals), with the lookback value subject to the documented
    lag-targeted-norms approximation (RewardCtx.norm_at_lag docstring) — no
    reference configuration has partial intervals."""
    hyperbolic = load_reference_module("pde_control_gym.src.environments1d.hyperbolic")
    tuned = load_reference_module("pde_control_gym.src.rewards.tuned_reward_1d")
    T, DT, DX = 0.015, 1e-4, 1e-2  # nt=151: intervals of 100 then 50 sub-steps
    u0 = np.full(100, 30.0, np.float32)  # ||u|| stays >> 20 -> fall-through
    ref = hyperbolic.TransportPDE1D(
        T=T, dt=DT, X=1.0, dx=DX,
        reward_class=tuned.TunedReward1D(int(round(T / DT)), -1e3, 3e2),
        normalize=False, sensing_loc="full", control_type="Dirchilet",
        sensing_type="Dirchilet", sensing_noise_func=lambda s: s,
        limit_pde_state_size=False, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda n: u0,
        reset_recirculation_func=lambda n: np.zeros(n, np.float32),
        control_sample_rate=0.01,
    )
    ref.reset()

    cfg = Boundary1DConfig(T=T, dt=DT, X=1.0, dx=DX, control_sample_rate=0.01)
    env = TransportEnv(cfg, TunedReward1D(int(round(T / DT)), -1e3, 3e2))
    state, _ = env.init_from(u0, np.zeros(100, np.float32))
    step = jax.jit(env.step)
    for i in range(2):
        robs, rrew, rterm, rtrunc, _ = ref.step(np.float32(0.0))
        state, out = step(state, jnp.float32(0.0))
        assert rterm == bool(out.terminated)
        if i == 0:  # full interval: exact
            np.testing.assert_allclose(rrew, float(out.reward), rtol=1e-4)
        else:  # partial terminal: same (fall-through) branch, not the +300 bonus
            assert abs(float(out.reward)) < 10.0 and abs(rrew) < 10.0
            np.testing.assert_allclose(rrew, float(out.reward), atol=2.0)
    assert rterm  # second interval was partial (50 of 100 sub-steps)


def test_autoreset_gate_paths_equivalent():
    """batch_step picks ungated vs cond-gated reset by per-env state size
    (rollout.py); both paths must produce identical trajectories. Forced by
    stepping the same small env through both code paths (the size heuristic
    is trace-time, so we call the internals directly)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdecontrolgym_jax.envs.common import Boundary1DConfig
    from pdecontrolgym_jax.envs.transport import TransportEnv
    from pdecontrolgym_jax.parallel.rollout import batch_init, batch_step
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    cfg = Boundary1DConfig(T=0.3, dt=1e-3, X=1.0, dx=1.0 / 32,
                           control_sample_rate=1e-2)
    env = TransportEnv(cfg, TunedReward1D(cfg.nt - 1))
    B = 8
    state, obs = batch_init(env, B)(jax.random.key(0))
    step = batch_step(env, autoreset=True)

    # compare the two paths directly: the ungated step (what the size
    # heuristic picks for this small state) vs a manual cond-gated mirror,
    # over an episode that terminates inside the scan (nt-1 = 300 sub-steps
    # -> terminal at agent step 30 when scanning 35)
    def rollout(step_fn, steps=35):
        def body(c, k):
            st, ob = c
            a = -0.5 * ob[..., -2]
            st, out = step_fn(st, a, k)
            return (st, out.obs), (out.obs, out.reward, out.terminated)
        keys = jax.random.split(jax.random.key(1), steps)
        (_, _), outs = jax.lax.scan(body, (state, obs), keys)
        return outs

    ungated = jax.jit(lambda: rollout(step))()

    # build a cond-gated step manually (mirrors the >=16KB branch)
    def gated(st, actions, key):
        next_state, out = env.step_batch(st, actions)
        done = jnp.logical_or(out.terminated, out.truncated)

        def do_reset(op):
            ns, o, k = op
            fs, fo = jax.vmap(env.init)(jax.random.split(k, B))
            sel = lambda a, b: jnp.where(
                done.reshape(done.shape + (1,) * (a.ndim - done.ndim)), a, b)
            return jax.tree_util.tree_map(sel, fs, ns), o.replace(obs=sel(fo, o.obs))

        return jax.lax.cond(done.any(), do_reset, lambda op: (op[0], op[1]),
                            (next_state, out, key))

    gated_outs = jax.jit(lambda: rollout(gated))()
    # semantically identical; the two compiled programs fuse the reward
    # reduction differently, so allow f32 rounding-level differences
    for a, b in zip(jax.tree_util.tree_leaves(ungated),
                    jax.tree_util.tree_leaves(gated_outs)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=1e-4, atol=1e-5)


def test_bench_neuron_timed_scalar_depends_on_physics():
    """Round-2's neuron bench attached no reward, so its timed scalar was a
    constant zero and XLA dead-code-eliminated the entire rollout (advisor
    finding). The bench now folds the final observation into the scalar;
    this pins the property: different rollout keys must produce different
    timed values (a DCE'd program returns a key-independent constant)."""
    from pdecontrolgym_jax.envs.neuron import NeuronConfig, NeuronEnv
    from pdecontrolgym_jax.parallel.rollout import rollout

    env = NeuronEnv(NeuronConfig(dtype=jnp.float32))  # NO reward attached

    # the exact timed quantity bench_families._measure builds
    def episode(key):
        (_, obs), outs = rollout(env, lambda o, _k: jnp.zeros(o.shape[:-1]),
                                 4, 5, key)
        return outs.reward.sum().astype(jnp.float32) + obs.sum().astype(jnp.float32)

    a = float(jax.jit(episode)(jax.random.key(0)))
    b = float(jax.jit(episode)(jax.random.key(1)))
    assert np.isfinite(a) and np.isfinite(b)
    # neuron init is deterministic (no IC sampling), so different keys give
    # the same trajectory — the guard here is that the scalar reflects the
    # PHYSICS, not a constant zero
    assert abs(a) > 1e-3, "timed scalar is ~0: the rollout was DCE'd again"


def test_noise_gate_sees_through_wrappers():
    """The PPO/SAC fused-rollout gate must detect noise_fn ANYWHERE in the
    wrapper chain (review finding: checking only the outermost env silently
    dropped sensing noise for wrapped noisy envs)."""
    from pdecontrolgym_jax.envs import TransformObsEnv
    from pdecontrolgym_jax.parallel.rollout import env_noise_fn

    noise = lambda obs, key: obs + jax.random.normal(key, obs.shape) * 1e-3
    cfg = Boundary1DConfig(T=0.05, dt=1e-3, X=1.0, dx=1.0 / 32,
                           control_sample_rate=1e-2)
    noisy = TransportEnv(cfg, TunedReward1D(cfg.nt - 1), noise_fn=noise)
    wrapped = TransformObsEnv(noisy, lambda o: o * 2.0)
    assert env_noise_fn(wrapped) is noise
    assert env_noise_fn(TransportEnv(cfg, TunedReward1D(cfg.nt - 1))) is None

    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer

    trainer = PPOTrainer(wrapped, PPOConfig(num_envs=4, num_steps=2,
                                            num_epochs=1, num_minibatches=1,
                                            hidden=(8, 8)))
    # the noisy env must take the per-env path, which threads noise keys
    runner = trainer.init(jax.random.key(0))
    state, out = trainer._env_step(runner.env_state,
                                   jnp.zeros(4), jax.random.key(1))
    state2, out2 = trainer._env_step(runner.env_state,
                                     jnp.zeros(4), jax.random.key(2))
    # different keys -> different noisy observations (noise IS applied)
    assert not np.allclose(np.asarray(out.obs), np.asarray(out2.obs))


def test_adapter_fast_path_env_u_is_writable():
    """env.u must stay a mutable numpy array on the device-history fast path
    (review finding: the raw jax-array view was read-only)."""
    from pdecontrolgym_jax.compat.adapter import TransportPDE1D

    env = TransportPDE1D(
        T=0.05, dt=1e-3, X=1.0, dx=1.0 / 32, control_sample_rate=1e-2,
        reset_init_condition_func=lambda nx: np.ones(nx, np.float32),
        reset_recirculation_func=lambda nx: np.zeros(nx, np.float32),
    )
    env.reset()
    assert not env._host_history
    env.u[0] = 7.0  # reference-style in-place mutation must not raise
    assert np.allclose(env.u[0], 7.0)  # and persists between reads
    env.step(np.float32(0.1))
    # the next step refreshed the cache from the device buffer (documented)
    assert not np.allclose(env.u[0], 7.0)


def test_ns_lockstep_default_poisons_mixed_time_batches():
    """lockstep_targets=True computes rewards from one shared target row;
    hand-built mixed-time batches must fail LOUD (NaN), not silently reward
    against the wrong row (review finding)."""
    from pdecontrolgym_jax.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
    )
    from pdecontrolgym_jax.rewards.ns import NSReward

    n = 8
    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"],
        "right": ["Dirchilet", "Dirchilet"],
    })
    cfg = NavierStokesConfig(
        T=0.02, dt=1e-3, X=1.0, dx=1.0 / (n - 1), Y=1.0, dy=1.0 / (n - 1),
        boundary_condition=bc, dtype=jnp.float32, viscosity=0.01,
        pressure_solver="jacobi", maximum_pressure_iteration=5,
    )
    env = NavierStokesEnv(cfg, NSReward(0.1),
                          np.zeros((cfg.nt, n, n, 2), np.float32),
                          np.zeros(cfg.nt, np.float32))
    state, _ = jax.vmap(env.init)(jax.random.split(jax.random.key(0), 4))
    # lockstep batch: finite rewards
    _, out = jax.jit(env.step_batch)(state, jnp.full((4, 1), 1.0))
    assert np.isfinite(np.asarray(out.reward)).all()
    # mixed times: poisoned rewards
    mixed = state.replace(time_index=jnp.asarray([0, 1, 0, 0], jnp.int32))
    _, out = jax.jit(env.step_batch)(mixed, jnp.full((4, 1), 1.0))
    assert np.isnan(np.asarray(out.reward)).all()
