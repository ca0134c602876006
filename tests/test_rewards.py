"""Reward classes: repaired NormReward modes, noise hook, reward plumbing."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.norm import NormReward
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def _env(reward, **kw):
    cfg = Boundary1DConfig(
        T=0.1, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.01, **kw
    )
    return TransportEnv(cfg, reward)


@pytest.mark.parametrize("horizon", ["temporal", "differential", "t-horizon"])
def test_norm_reward_modes_run_and_sign(horizon):
    rew = NormReward(nt=100, norm="2", horizon=horizon, t_horizon_length=4)
    env = _env(rew)
    u0 = np.full(100, 2.0, np.float32)
    state, _ = env.init_from(u0, np.zeros(100, np.float32))
    step = jax.jit(env.step)
    vals = []
    for _ in range(3):
        state, out = step(state, jnp.float32(0.0))
        vals.append(float(out.reward))
    assert np.isfinite(vals).all()
    if horizon in ("temporal", "t-horizon"):
        assert all(v < 0 for v in vals)  # -norm / -avg norm
    else:
        assert all(v >= 0 for v in vals)  # +|difference| (reference sign)


def test_norm_reward_validation():
    with pytest.raises(ValueError, match="norm"):
        NormReward(nt=10, norm="3")
    with pytest.raises(ValueError, match="horizon"):
        NormReward(nt=10, horizon="spatial")


def test_norm_reward_terminate_truncate_values():
    rew = NormReward(nt=100, terminate_reward=55.0, truncate_penalty=-2.0)
    env = _env(rew)
    u0 = np.zeros(100, np.float32)
    state, _ = env.init_from(u0, np.zeros(100, np.float32))
    step = jax.jit(env.step)
    out = None
    for _ in range(10):
        state, out = step(state, jnp.float32(0.0))
    assert bool(out.terminated) and float(out.reward) == 55.0


def test_l1_linf_norms():
    u = jnp.asarray([[3.0, -4.0, 0.0]])
    from pdecontrolgym_jax.rewards.norm import _vec_norm

    assert float(_vec_norm(u, "1")[0]) == 7.0
    assert float(_vec_norm(u, "2")[0]) == 5.0
    assert float(_vec_norm(u, "inf")[0]) == 4.0


def test_sensing_noise_prng_hook():
    """Functional noise hook: pure fn of (obs, key), applied per step."""
    rew = TunedReward1D(100, lookback=5)
    cfg = Boundary1DConfig(T=0.1, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.01)
    noisy = TransportEnv(cfg, rew, noise_fn=lambda obs, key: obs + 100.0)
    clean = TransportEnv(cfg, rew)
    u0 = np.zeros(100, np.float32)
    sn, _ = noisy.init_from(u0, u0)
    sc, _ = clean.init_from(u0, u0)
    k = jax.random.key(0)
    sn, on = jax.jit(noisy.step)(sn, jnp.float32(0.1), k)
    sc, oc = jax.jit(clean.step)(sc, jnp.float32(0.1), k)
    np.testing.assert_allclose(np.asarray(on.obs), np.asarray(oc.obs) + 100.0)
    # without a key the noise hook is skipped (pure rollouts stay deterministic)
    sn, on2 = jax.jit(lambda s, a: noisy.step(s, a))(sn, jnp.float32(0.1))
    assert np.abs(np.asarray(on2.obs)).max() < 50.0


@pytest.mark.parametrize("norm", ["1", "2", "inf"])
def test_norm_reward_t_horizon_matches_full_history(norm):
    """t-horizon for every norm ord (reference norm_reward.py:52-66 semantics):
    -(1/min(H,t)) * sum_i ||u(t-i)||_ord, computed against a replayed full
    sub-step history. L1/L-inf exercise the auxiliary norm ring."""
    H = 4
    rew = NormReward(nt=101, norm=norm, horizon="t-horizon", t_horizon_length=H)
    env = _env(rew)
    u0 = np.linspace(0.5, 2.0, 100).astype(np.float32)
    beta = np.full(100, 0.8, np.float32)
    state, _ = env.init_from(u0, beta)
    state2, _ = env.init_from(u0, beta)  # plain-step twin
    hist = [u0]
    ords = {"1": 1, "2": 2, "inf": np.inf}
    step_h = jax.jit(env.step_with_history)
    step = jax.jit(lambda s, a: env.step(s, a))
    for k in range(4):
        state, out, rows = step_h(state, jnp.float32(0.3))
        state2, out2 = step(state2, jnp.float32(0.3))
        hist.extend(list(np.asarray(rows)))
        t = int(state.time_index)
        vals = [np.linalg.norm(hist[t - i], ord=ords[norm])
                for i in range(min(H, t))]
        expect = -np.mean(vals)
        np.testing.assert_allclose(float(out.reward), expect, rtol=1e-5)
        np.testing.assert_allclose(float(out2.reward), expect, rtol=1e-5)
