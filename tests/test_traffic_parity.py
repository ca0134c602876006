"""ARZ traffic env parity vs the reference (float64 oracle on CPU)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_jax.rewards.traffic import TrafficARZReward

from reference_loader import load_reference_module

PARAMS = dict(T=240.0, dt=0.25, X=500.0, dx=10.0, v_steady=10.0, ro_steady=0.12,
              v_max=40.0, ro_max=0.16, tau=60.0)


def _ref_env(simulation_type, control_freq=1):
    arz = load_reference_module("pde_control_gym.src.environments1d.traffic_arz_env")
    rew = load_reference_module("pde_control_gym.src.rewards.traffic_arz_reward")
    return arz.TrafficPDE1D(
        simulation_type=simulation_type,
        control_freq=control_freq,
        reward_class=rew.TrafficARZReward(),
        normalize=False,
        **PARAMS,
    )


def _jax_env(simulation_type, control_freq=1):
    cfg = TrafficARZConfig(
        simulation_type=simulation_type,
        control_freq=control_freq,
        dtype=jnp.float64,
        **PARAMS,
    )
    return TrafficARZEnv(cfg, TrafficARZReward())


@pytest.mark.parametrize("mode,cf", [("inlet", 1), ("outlet", 1), ("outlet", 2), ("both", 1)])
def test_open_loop_parity(mode, cf):
    ref = _ref_env(mode, cf)
    robs, _ = ref.reset()

    env = _jax_env(mode, cf)
    step = jax.jit(env.step)
    state, tobs = env.init(None)
    np.testing.assert_allclose(robs, np.asarray(tobs), rtol=1e-12)

    qs = ref.qs
    rng = np.random.default_rng(5)
    n_act = 2 if mode == "both" else 1
    for i in range(40):
        a = rng.uniform(0.85 * qs, 1.15 * qs, size=n_act)
        robs, rrew, rterm, rtrunc, rinfo = ref.step(a)
        state, out = step(state, jnp.asarray(a))
        np.testing.assert_allclose(robs, np.asarray(out.obs), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(rrew, float(out.reward), rtol=1e-9)
        assert rterm == bool(out.terminated)
        assert rtrunc == bool(out.truncated)
        if rterm or rtrunc:
            break


def test_outlet_backstepping_closed_loop_parity_and_early_stop():
    """The tutorial's outlet backstepping law, run to the early-stop threshold
    on both engines (Trafficarz1d_tutorial.rst:146-186)."""

    def controller(env_like, v, r):
        x = np.arange(0, PARAMS["X"] + PARAMS["dx"], PARAMS["dx"])
        vs, rs = env_like["vs"], env_like["rs"]
        vm, rm, tau, ps, qs = (
            env_like["vm"], env_like["rm"], env_like["tau"], env_like["ps"], env_like["qs"],
        )
        lambda2 = vs + rs * (-vm / rm)
        K = -(1 / ps) * (-1 / tau) * np.exp(-x / (tau * vs))
        M_k = -K
        cv = M_k + (lambda2 / vs) * K * np.exp(x / (vs * tau))
        cq = ((vs - lambda2) / vs) * K * np.exp(x / (vs * tau))
        v_err, q_err = v - vs, r * v - qs
        return (
            qs
            + rs * np.trapezoid(cv * v_err, dx=PARAMS["dx"])
            + np.trapezoid(cq * q_err, dx=PARAMS["dx"])
        )

    ref = _ref_env("outlet")
    attrs = dict(vs=ref.vs, rs=ref.rs, vm=ref.vm, rm=ref.rm, tau=ref.tau,
                 ps=ref.ps, qs=ref.qs)
    obs, _ = ref.reset()
    M = ref.M
    ref_rews, term, trunc, steps = [], False, False, 0
    while not (term or trunc) and steps < 5000:
        a = controller(attrs, obs[M:], obs[:M])
        obs, r, term, trunc, _ = ref.step(np.array([a]))
        ref_rews.append(r)
        steps += 1
    ref_steps = steps

    env = _jax_env("outlet")
    step = jax.jit(env.step)
    state, tobs = env.init(None)
    jax_rews, done, steps = [], False, 0
    while not done and steps < 5000:
        o = np.asarray(tobs)
        a = controller(attrs, o[M:], o[:M])
        state, out = step(state, jnp.asarray([a]))
        tobs = out.obs
        jax_rews.append(float(out.reward))
        done = bool(out.terminated) or bool(out.truncated)
        steps += 1

    assert ref_steps == steps  # identical episode length
    np.testing.assert_allclose(ref_rews, jax_rews, rtol=1e-8)
    # controller drives the tracking error down by >10x over the episode
    assert jax_rews[-1] > jax_rews[0] / 10


def test_invalid_configs_raise():
    with pytest.raises(ValueError, match="equilibrium"):
        _jax_env("inlet")  # default ok...
        TrafficARZEnv(
            TrafficARZConfig(simulation_type="inlet", v_steady=11.0), TrafficARZReward()
        )
    with pytest.raises(ValueError, match="Invalid simulation type"):
        TrafficARZEnv(TrafficARZConfig(simulation_type="sideways"), TrafficARZReward())


def test_train_mode_resamples_steady_state():
    env = _jax_env("outlet-train")
    seen = set()
    for i in range(12):
        state, obs = env.init(jax.random.key(i))
        seen.add(round(float(state.rs), 4))
        assert obs.shape == (2 * env.config.M,)
        # normalized observation at reset: (r-rs)/rs bounded by the 0.1 sine
        assert np.abs(np.asarray(obs[: env.config.M])).max() < 0.11
    assert len(seen) > 1
