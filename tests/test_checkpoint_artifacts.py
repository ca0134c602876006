"""The committed policy checkpoints (examples/checkpoints/*.msgpack) restore
and still control their envs.

These are the artifacts the walkthrough notebooks load (examples/
make_notebooks.py) and the quality tables cite (docs/STATUS.md). Each test
restores the msgpack into a freshly-initialized param template and evaluates a
few episodes on CPU, asserting a loose-but-meaningful return floor (well above
the zero/untrained policy, well below the 50-episode table numbers, so
episode-count noise cannot flake it).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

CKPT = os.path.join(os.path.dirname(__file__), "..", "examples", "checkpoints")


def _load(name, template):
    from pdecontrolgym_jax.utils import load_params

    path = os.path.join(CKPT, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not committed yet")
    return load_params(path, template)


def _rd_env(normalize=True):
    import dataclasses

    from pdecontrolgym_jax.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    cfg = ReactionDiffusionConfig(
        T=1.0, dt=1e-5, X=1.0, dx=5e-3, control_sample_rate=1e-3,
        normalize=normalize, limit_pde_state_size=True, max_state_value=1e10,
        max_control_value=20.0,
    )
    return ReactionDiffusionEnv(cfg, TunedReward1D(100000, -1e3, 3e2))


def test_rd_ppo_checkpoint_controls():
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.eval import compare_controllers

    env = _rd_env()
    trainer = PPOTrainer(env, PPOConfig())
    template = trainer.net.init(jax.random.key(0), jnp.zeros((1, env.obs_dim)))
    params = _load("rd_ppo.msgpack", template)
    r = compare_controllers(env, {"ppo": trainer.policy(params)},
                            num_episodes=4, max_steps=1000)
    # 50-episode mean when trained: 291.79; zero policy: -62.9
    assert r["ppo"]["mean_return"] > 250.0


def test_rd_sac_checkpoint_controls():
    from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_jax.eval import compare_controllers

    env = _rd_env()
    trainer = SACTrainer(env, SACConfig())
    template = trainer.actor.init(jax.random.key(0), jnp.zeros((1, env.obs_dim)))
    params = _load("rd_sac.msgpack", template)
    r = compare_controllers(env, {"sac": trainer.policy(params)},
                            num_episodes=4, max_steps=1000)
    # 50-episode mean when trained: 276.00
    assert r["sac"]["mean_return"] > 230.0


def _transport_env(normalize=True):
    import dataclasses

    from pdecontrolgym_jax.envs.common import Boundary1DConfig
    from pdecontrolgym_jax.envs.transport import TransportEnv
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    cfg = Boundary1DConfig(
        T=5.0, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
        normalize=normalize, limit_pde_state_size=True, max_state_value=1e10,
        max_control_value=20.0,
    )
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)),
                                           -1e3, 3e2))


def test_transport_ppo_checkpoint_beats_backstepping_floor():
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.eval import compare_controllers

    env = _transport_env()
    trainer = PPOTrainer(env, PPOConfig())
    template = trainer.net.init(jax.random.key(0), jnp.zeros((1, env.obs_dim)))
    params = _load("transport_ppo.msgpack", template)
    r = compare_controllers(env, {"ppo": trainer.policy(params)},
                            num_episodes=4, max_steps=50)
    # 50-episode mean when trained: 249.89 (backstepping: 243.40; the pre-recipe
    # plateau without the terminal bonus: ~15)
    assert r["ppo"]["mean_return"] > 200.0


def test_transport_sac_checkpoint_controls():
    from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_jax.eval import compare_controllers

    env = _transport_env()
    trainer = SACTrainer(env, SACConfig())
    template = trainer.actor.init(jax.random.key(0), jnp.zeros((1, env.obs_dim)))
    params = _load("transport_sac.msgpack", template)
    r = compare_controllers(env, {"sac": trainer.policy(params)},
                            num_episodes=4, max_steps=50)
    # 50-episode mean when trained: 221.85 (reference published SAC: 179.90)
    assert r["sac"]["mean_return"] > 170.0


def test_traffic_ppo_checkpoint_beats_uncontrolled():
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.envs import TanhBoxActionEnv, TransformObsEnv
    from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
    from pdecontrolgym_jax.rewards import TrafficARZReward

    cfg = TrafficARZConfig(simulation_type="outlet")
    env = TrafficARZEnv(cfg, TrafficARZReward())
    M, rs, vs = cfg.M, cfg.ro_steady, cfg.v_steady
    env_pol = TransformObsEnv(
        TanhBoxActionEnv(env),
        lambda obs: jnp.concatenate([(obs[:M] - rs) / rs, (obs[M:] - vs) / vs]),
    )
    trainer = PPOTrainer(TanhBoxActionEnv(env), PPOConfig())
    template = trainer.net.init(jax.random.key(0), jnp.zeros((1, 2 * M)))
    params = _load("traffic_ppo.msgpack", template)
    pol = trainer.policy(params)

    @jax.jit
    def total_reward():
        state, obs = env_pol.init(None)

        def body(carry, _):
            state, obs = carry
            state, out = env_pol.step(state, pol(obs[None])[0])
            return (state, out.obs), out.reward

        (_, _), rewards = jax.lax.scan(body, (state, obs), None, length=960)
        return rewards.sum()

    total = float(total_reward())
    # training run: -204.57 (backstepping: -263.17); an untrained/zero outlet
    # policy diverges far below -1000
    assert total > -350.0


def _ns_env():
    from pdecontrolgym_jax.envs import FlatObsEnv, NavierStokesConfig, NavierStokesEnv
    from pdecontrolgym_jax.envs.navier_stokes import (
        freeze_boundary_condition,
        make_lid_target,
    )
    from pdecontrolgym_jax.rewards.ns import NSReward

    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"],
        "right": ["Dirchilet", "Dirchilet"],
    })
    cfg = NavierStokesConfig(
        T=0.2, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05,
        boundary_condition=bc, dtype=jnp.float32, pressure_solver="direct",
    )
    U_ref, action_ref = make_lid_target(cfg, lid=2.0)
    return FlatObsEnv(NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref))


def test_ns_ppo_checkpoint_tracks_lid():
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.eval import compare_controllers

    env = _ns_env()
    trainer = PPOTrainer(env, PPOConfig())
    _, obs0 = env.init(jax.random.key(0))
    template = trainer.net.init(jax.random.key(0), obs0[None])
    params = _load("ns_ppo.msgpack", template)
    r = compare_controllers(env, {"ppo": trainer.policy(params)},
                            num_episodes=4, max_steps=200)
    # 50-episode mean when trained: -5.40 (constant-lid oracle: -5.16, zero: -70.28)
    assert r["ppo"]["mean_return"] > -20.0


def test_ns_sac_checkpoint_tracks_lid():
    from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_jax.eval import compare_controllers

    env = _ns_env()
    trainer = SACTrainer(env, SACConfig(action_low=-4.0, action_high=4.0))
    _, obs0 = env.init(jax.random.key(0))
    template = trainer.actor.init(jax.random.key(0), obs0[None])
    params = _load("ns_sac.msgpack", template)
    r = compare_controllers(env, {"sac": trainer.policy(params)},
                            num_episodes=4, max_steps=200)
    # 50-episode mean when trained: -5.59 (constant-lid oracle: -5.16, zero: -70.28)
    assert r["sac"]["mean_return"] > -20.0


def test_brain_tumor_ppo_checkpoint_extends_survival():
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.envs import BrainTumorEnv, TherapyEnv
    from pdecontrolgym_jax.envs.brain_tumor import BrainTumorConfig
    from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward

    cfg = BrainTumorConfig(total_dosage=61.2)
    base = BrainTumorEnv(cfg, BrainTumorReward())
    tb = int(jax.jit(TherapyEnv(base).benchmark)(jax.random.key(0)))

    from pdecontrolgym_jax.envs.brain_tumor import DoseTherapyEnv

    env = DoseTherapyEnv(base, t_benchmark=tb)
    trainer = PPOTrainer(env, PPOConfig())
    template = trainer.net.init(jax.random.key(0), jnp.zeros((1, env.obs_dim)))
    params = _load("brain_tumor_ppo.msgpack", template)
    policy = trainer.policy(params)

    state, obs = env.init(jax.random.key(42))
    stepf = jax.jit(env.step)
    done = False
    while not done:
        state, out = stepf(state, policy(obs[None])[0])
        obs = out.obs
        done = bool(out.terminated) or bool(out.truncated)
    # training run: +73 days vs untreated; fixed protocols reach +67/+68
    assert int(state.simulation_days) - tb > 40


def test_traffic_sac_checkpoint_beats_backstepping():
    from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_jax.envs import TransformObsEnv
    from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
    from pdecontrolgym_jax.rewards import TrafficARZReward

    cfg = TrafficARZConfig(simulation_type="outlet")
    env = TrafficARZEnv(cfg, TrafficARZReward())
    M, rs, vs = cfg.M, cfg.ro_steady, cfg.v_steady
    env_pol = TransformObsEnv(
        env,
        lambda obs: jnp.concatenate([(obs[:M] - rs) / rs, (obs[M:] - vs) / vs]),
    )
    # SAC's tanh actor scales straight onto the flux box (no TanhBoxActionEnv)
    trainer = SACTrainer(env, SACConfig(
        action_low=float(env.action_low), action_high=float(env.action_high)))
    template = trainer.actor.init(jax.random.key(0), jnp.zeros((1, 2 * M)))
    params = _load("traffic_sac.msgpack", template)
    pol = trainer.policy(params)

    @jax.jit
    def total_reward():
        state, obs = env_pol.init(None)

        def body(carry, _):
            state, obs = carry
            state, out = env_pol.step(state, pol(obs[None])[0])
            return (state, out.obs), out.reward

        (_, _), rewards = jax.lax.scan(body, (state, obs), None, length=960)
        return rewards.sum()

    total = float(total_reward())
    # training run: -137.25 (PPO: -204.57, backstepping: -263.17)
    assert total > -263.0  # at least beats the analytic controller


def test_brain_tumor_sac_checkpoint_extends_survival():
    from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_jax.envs import BrainTumorEnv, TherapyEnv
    from pdecontrolgym_jax.envs.brain_tumor import BrainTumorConfig
    from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward

    cfg = BrainTumorConfig(total_dosage=61.2)
    base = BrainTumorEnv(cfg, BrainTumorReward())
    tb = int(jax.jit(TherapyEnv(base).benchmark)(jax.random.key(0)))

    from pdecontrolgym_jax.envs.brain_tumor import DoseTherapyEnv

    env = DoseTherapyEnv(base, t_benchmark=tb)
    trainer = SACTrainer(env, SACConfig())
    template = trainer.actor.init(jax.random.key(0), jnp.zeros((1, env.obs_dim)))
    params = _load("brain_tumor_sac.msgpack", template)
    policy = trainer.policy(params)

    state, obs = env.init(jax.random.key(42))
    stepf = jax.jit(env.step)
    done = False
    while not done:
        state, out = stepf(state, policy(obs[None])[0])
        obs = out.obs
        done = bool(out.terminated) or bool(out.truncated)
    survival = int(state.simulation_days)
    # training run: +74 days vs the 363-day untreated baseline; fixed protocols
    # reach +67/+68
    assert survival - tb > 40
