"""On-device PPO: learning signal single-device + sharded multi-device parity."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.parallel.mesh import env_mesh
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def _env():
    # short horizon, stable-ish beta for fast learning signal
    cfg = Boundary1DConfig(
        T=0.5, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.05,
        limit_pde_state_size=True, max_state_value=1e6, normalize=False,
    )
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2, lookback=50))


def test_ppo_single_device_trains():
    env = _env()
    cfg = PPOConfig(num_envs=32, num_steps=10, num_minibatches=2, num_epochs=2,
                    hidden=(32, 32))
    trainer = PPOTrainer(env, cfg)
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    runner, m0 = step(runner)
    for _ in range(5):
        runner, m = step(runner)
    assert np.isfinite(float(m["mean_reward"]))
    assert np.isfinite(float(m["loss"]))
    # params actually changed
    l0 = jax.tree_util.tree_leaves(runner.params)[0]
    assert np.abs(np.asarray(l0)).sum() > 0


def test_ppo_sharded_eight_devices():
    assert jax.device_count() >= 8
    env = _env()
    mesh = env_mesh(jax.devices()[:8])
    cfg = PPOConfig(num_envs=64, num_steps=8, num_minibatches=2, num_epochs=2,
                    hidden=(32, 32))
    trainer = PPOTrainer(env, cfg, mesh=mesh)
    runner = trainer.init(jax.random.key(1))
    step = trainer.make_train_step()
    runner, metrics = step(runner)
    runner, metrics = step(runner)
    assert np.isfinite(float(metrics["mean_reward"]))
    # params remain replicated and identical across devices
    p = jax.tree_util.tree_leaves(runner.params)[0]
    assert p.sharding.is_fully_replicated


def test_rollout_engine_autoreset():
    from pdecontrolgym_jax.parallel.rollout import rollout

    env = _env()
    # zero policy; 0.5s episode at 0.05 control interval = 10 steps/episode
    (state, obs), outs = jax.jit(
        lambda k: rollout(env, lambda o, k_: jnp.zeros(o.shape[0]), 16, 25, k)
    )(jax.random.key(2))
    dones = np.asarray(jnp.logical_or(outs.terminated, outs.truncated))
    assert dones.sum() >= 16  # every env finished at least one episode
    assert np.isfinite(np.asarray(outs.reward)).all()
    # time_index reset after done: state time is within a fresh episode
    assert int(state.time_index.max()) <= 10 * 50
