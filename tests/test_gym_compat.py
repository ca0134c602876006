"""Gymnasium adapter: reference kwargs API + registered IDs work unmodified."""

import numpy as np
import gymnasium as gym
import pytest

import pdecontrolgym_jax  # noqa: F401  (registers env IDs)
from pdecontrolgym_jax.compat import registration
from pdecontrolgym_jax.rewards import TunedReward1D


def _params(T=1.0, dt=1e-4, dx=1e-2):
    return {
        "T": T,
        "dt": dt,
        "X": 1.0,
        "dx": dx,
        "reward_class": TunedReward1D(int(round(T / dt)), -1e3, 3e2),
        "normalize": False,
        "sensing_loc": "full",
        "control_type": "Dirchilet",
        "sensing_type": None,
        "sensing_noise_func": lambda state: state,
        "limit_pde_state_size": True,
        "max_state_value": 1e10,
        "max_control_value": 20,
        "reset_init_condition_func": lambda nx: np.ones(nx, np.float32) * 2,
        "reset_recirculation_func": lambda nx: np.zeros(nx, np.float32),
        "control_sample_rate": 0.1,
    }


def test_gym_make_transport_five_tuple():
    env = gym.make("PDEControlGym-TransportPDE1D", **_params())
    obs, info = env.reset()
    assert obs.shape == (100,)
    assert isinstance(info, dict)
    total = 0.0
    for _ in range(10):
        obs, rew, term, trunc, info = env.step(np.float32(0.1))
        total += rew
        if term or trunc:
            break
    assert term  # T=1, rate 0.1 -> exactly 10 agent steps
    assert np.isfinite(total)


def test_reset_without_callbacks_raises_reference_message():
    env = gym.make("PDEControlGym-TransportPDE1D", **{**_params(), "reset_init_condition_func": None})
    try:
        env.reset()
        raised = False
    except Exception as e:
        raised = "initial condition" in str(e)
    assert raised


def test_spaces_match_reference_shapes():
    env = gym.make("PDEControlGym-TransportPDE1D", **_params()).unwrapped
    assert env.observation_space.shape == (100,)
    assert env.action_space.shape == (1,)
    env2 = gym.make(
        "PDEControlGym-TransportPDE1D", **{**_params(), "sensing_loc": "collocated"}
    ).unwrapped
    assert env2.observation_space.shape == (1,)


def test_gym_make_traffic():
    env = gym.make(
        "PDEControlGym-TrafficPDE1D",
        T=240.0, dt=0.25, X=500.0, dx=10.0,
        simulation_type="outlet", v_steady=10, ro_steady=0.12,
        v_max=40, ro_max=0.16, tau=60, verbose=False,
    )
    obs, info = env.reset()
    assert obs.shape == (102,)
    u = env.unwrapped
    assert u.action_space.shape == (1,)
    assert np.isclose(u.action_space.low[0], 0.8 * 1.2)
    obs, rew, term, trunc, info = env.step(np.array([1.2]))
    assert "V" in info and np.isfinite(rew)
    # tutorial-visible attributes
    for attr in ("qs", "vs", "rs", "vm", "rm", "ps", "tau", "L", "v", "r"):
        assert hasattr(u, attr)


def test_gym_make_neuron():
    env = gym.make("PDEControlGym-NeuronPDE1D")
    obs, _ = env.reset()
    L0 = env.unwrapped.L
    assert obs.shape == (L0,)
    obs, rew, term, trunc, _ = env.step(None)
    assert np.isfinite(obs).all() and not term


def test_device_history_matches_host_history():
    """The fast path keeps the (nt, n) history buffer on DEVICE (one packed
    host read per step); it must expose exactly the same ``env.u`` as the
    host-buffer mode used for legacy rewards — including past termination,
    where the frozen interval tail lands in the buffer's margin rows."""
    from pdecontrolgym_jax.compat.adapter import TransportPDE1D

    mk = lambda: TransportPDE1D(**_params())
    fast, slow = mk(), mk()
    assert not fast._host_history  # native reward -> device-history path
    slow._host_history = True
    fast.reset(seed=0)
    slow.reset(seed=0)
    for i in range(12):  # 10 steps terminate the episode; 2 past-terminal
        of, rf, tf, cf, _ = fast.step(np.float32(0.1 * (i % 3)))
        os_, rs, ts, cs, _ = slow.step(np.float32(0.1 * (i % 3)))
        np.testing.assert_array_equal(of, os_)
        assert (rf, tf, cf) == (rs, ts, cs)
        assert fast.time_index == slow.time_index
    np.testing.assert_array_equal(fast.u, slow.u)
    assert fast.u.shape == (fast.nt, fast.state_dim)


def test_legacy_reference_reward_object_through_adapter():
    """Pass the REFERENCE's own TunedReward1D instance (ABC-style signature,
    full-history indexing) through the Gymnasium adapter: rewards must match the
    native path within float tolerance."""
    import sys
    sys.path.insert(0, "tests")
    from reference_loader import load_reference_module

    ref_tuned = load_reference_module("pde_control_gym.src.rewards.tuned_reward_1d")
    params = _params()
    env_native = gym.make("PDEControlGym-TransportPDE1D", **params)
    env_legacy = gym.make(
        "PDEControlGym-TransportPDE1D",
        **{**params, "reward_class": ref_tuned.TunedReward1D(10000, -1e3, 3e2)},
    )
    on, _ = env_native.reset()
    ol, _ = env_legacy.reset()
    for i in range(10):
        on, rn, tn, _, _ = env_native.step(np.float32(0.2))
        ol, rl, tl, _, _ = env_legacy.step(np.float32(0.2))
        np.testing.assert_allclose(on, ol, atol=1e-6)
        np.testing.assert_allclose(rn, rl, rtol=1e-4, atol=1e-4)
        assert tn == tl


def test_vector_env_adapter():
    from pdecontrolgym_jax.compat.vector import PDEVectorEnv
    from pdecontrolgym_jax.envs.common import Boundary1DConfig
    from pdecontrolgym_jax.envs.transport import TransportEnv
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    cfg = Boundary1DConfig(T=0.05, dt=1e-4, X=1.0, dx=1e-2,
                           control_sample_rate=0.01)
    fenv = TransportEnv(cfg, TunedReward1D(500, -1e3, 3e2, lookback=5))
    venv = PDEVectorEnv(fenv, num_envs=16)
    obs, info = venv.reset(seed=3)
    assert obs.shape == (16, 100) and obs.dtype == np.float32
    for i in range(5):
        obs, rew, term, trunc, _ = venv.step(np.zeros((16, 1), np.float32))
    assert term.all()  # 5 steps to the horizon
    # autoreset: next step starts fresh episodes
    obs, rew, term, trunc, _ = venv.step(np.zeros((16, 1), np.float32))
    assert not term.any()


# One valid kwargs set per registered ID (the conformance contract covers
# every ID, parametrized below). Factories so per-test state never leaks.
# Neuron is checked with scalar (collocated) sensing: full sensing observes
# the dynamic-length u[:L] of the moving boundary — the reference's new_u,
# neuron_env.py:325-331 — which no fixed Box can contain by design.
_CONFORMANCE_KWARGS = {
    "PDEControlGym-TransportPDE1D": lambda: {**_params(), "normalize": True},
    "PDEControlGym-TrafficPDE1D": lambda: dict(
        T=240.0, dt=0.25, X=500.0, dx=10.0, simulation_type="outlet",
        v_steady=10, ro_steady=0.12, v_max=40, ro_max=0.16, tau=60,
        verbose=False,
    ),
    "PDEControlGym-ReactionDiffusionPDE1D": lambda: dict(
        T=0.01, dt=1e-5, X=1.0, dx=5e-3,
        reward_class=TunedReward1D(1000, -1e3, 3e2),
        normalize=True, sensing_loc="full", control_type="Dirchilet",
        sensing_type="Neumann", sensing_noise_func=lambda s: s,
        limit_pde_state_size=True, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda n: np.ones(n + 1, np.float32),
        reset_recirculation_func=lambda n: np.zeros(n + 1, np.float32),
        control_sample_rate=1e-3,
    ),
    "PDEControlGym-Burgers1D": lambda: dict(
        T=0.05, dt=1e-4, X=1.0, dx=1.0 / 128,
        reward_class=TunedReward1D(500),
        normalize=True, sensing_loc="full", control_type="Dirchilet",
        sensing_type=None, sensing_noise_func=lambda s: s,
        limit_pde_state_size=True, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda n: np.sin(
            np.pi * np.linspace(0, 1, n)
        ).astype(np.float32),
        reset_recirculation_func=lambda n: np.zeros(n, np.float32),
        control_sample_rate=0.01, viscosity=1e-3,
    ),
    "PDEControlGym-NavierStokes2D": lambda: dict(
        T=0.05, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05, action_dim=1,
        normalize=True,
        reset_init_condition_func=lambda X: (
            np.ones((21, 21)), -0.5 * np.ones((21, 21)), np.zeros((21, 21))
        ),
        boundary_condition={
            "upper": ["Controllable", "Dirchilet"],
            "lower": ["Dirchilet", "Dirchilet"],
            "left": ["Dirchilet", "Dirchilet"],
            "right": ["Dirchilet", "Dirchilet"],
        },
        U_ref=np.zeros((50, 21, 21, 2)), action_ref=np.zeros(50),
        maximum_pressure_iteration=40,
    ),
    "PDEControlGym-BrainTumor1D": lambda: dict(
        T=600.0, dt=1.0, X=200.0, dx=1.0,
        reset_init_condition_func=lambda X=200.0, nx=201: (
            0.8e5 * np.exp(-0.25 * np.linspace(0, X, nx) ** 2)
        ),
        total_dosage=61.2, verbose=False, normalize=True,
    ),
    "PDEControlGym-NeuronPDE1D": lambda: dict(sensing_loc="collocated"),
}


@pytest.mark.parametrize("env_id", sorted(registration._SPECS))
def test_gymnasium_official_conformance_checker(env_id):
    """gymnasium.utils.env_checker over EVERY registered ID — the check the
    reference imports but never runs (transport1Dppo.py:8)."""
    from gymnasium.utils.env_checker import check_env

    env = gym.make(env_id, **_CONFORMANCE_KWARGS[env_id]()).unwrapped
    check_env(env, skip_render_check=True)


def test_vector_env_non_square_ns_obs_shape():
    import jax.numpy as jnp
    from pdecontrolgym_jax.compat.vector import PDEVectorEnv
    from pdecontrolgym_jax.envs.navier_stokes import (
        NavierStokesConfig, NavierStokesEnv, freeze_boundary_condition,
    )
    from pdecontrolgym_jax.rewards.ns import NSReward

    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"],
        "right": ["Dirchilet", "Dirchilet"],
    })
    cfg = NavierStokesConfig(T=0.02, dt=1e-3, X=1.0, dx=0.05, Y=2.0, dy=0.05,
                             maximum_pressure_iteration=10,
                             boundary_condition=bc, dtype=jnp.float32)
    env = NavierStokesEnv(cfg, NSReward(0.1),
                          np.zeros((cfg.nt, cfg.ny, cfg.nx, 2), np.float32),
                          np.zeros(cfg.nt, np.float32))
    venv = PDEVectorEnv(env, num_envs=3)
    obs, _ = venv.reset()
    assert venv.single_observation_space.shape == obs.shape[1:]  # (ny, nx, 2)
    assert obs.shape == (3, cfg.ny, cfg.nx, 2)


def test_ns_adapter_fast_solver_kwargs():
    """The NS Gym adapter accepts the ADDITIVE kwargs (pressure_solver /
    pressure_layout / dtype) after the reference signature;
    defaults still reproduce the reference's f64 Jacobi configuration."""
    import numpy as np

    from pdecontrolgym_jax.compat.adapter import NavierStokes2D

    ic = lambda X: (np.ones_like(X), np.zeros_like(X), np.zeros_like(X))
    env = NavierStokes2D(
        reset_init_condition_func=ic,
        T=0.01, dt=1e-3, X=1.0, dx=0.1, Y=1.0, dy=0.1,
        pressure_solver="direct", dtype=np.float32,
    )
    assert env.fenv.config.pressure_solver == "direct"
    obs, _ = env.reset()
    assert obs.dtype == np.float32
    assert env.observation_space.dtype == np.float32
    o2, r, term, trunc, _ = env.step(np.array([0.5]))
    assert np.isfinite(r) and o2.shape == obs.shape
    # defaults unchanged: plain construction still builds f64 jacobi
    env0 = NavierStokes2D(reset_init_condition_func=ic,
                          T=0.01, dt=1e-3, X=1.0, dx=0.1, Y=1.0, dy=0.1)
    assert env0.fenv.config.pressure_solver == "jacobi"
