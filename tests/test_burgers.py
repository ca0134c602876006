"""Burgers env: conservation/shock sanity, boundary control, gym adapter."""

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def _env(**kw):
    cfg = BurgersConfig(T=0.5, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01, **kw)
    return BurgersEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))


def test_zero_state_stays_zero():
    env = _env()
    u0 = np.zeros(256, np.float32)
    state, _ = env.init_from(u0, u0)
    state, out = jax.jit(env.step)(state, jnp.float32(0.0))
    assert np.allclose(np.asarray(state.u), 0.0)


def test_rarefaction_decays_and_stays_finite():
    env = _env()
    x = np.linspace(0, 1, 256)
    u0 = np.sin(np.pi * x).astype(np.float32)  # forms a shock, then decays
    state, _ = env.init_from(u0, np.zeros_like(u0))
    step = jax.jit(env.step)
    norms = [float(jnp.linalg.norm(state.u))]
    for _ in range(50):
        state, out = step(state, jnp.float32(0.0))
        norms.append(float(jnp.linalg.norm(state.u)))
    assert np.isfinite(norms).all()
    assert norms[-1] < norms[0]  # dissipative scheme + viscosity decay
    assert not bool(out.truncated)


def test_dirichlet_boundary_control_sets_edge():
    env = _env()
    u0 = np.zeros(256, np.float32)
    state, _ = env.init_from(u0, u0)
    state, out = jax.jit(env.step)(state, jnp.float32(0.7))
    assert abs(float(state.u[-1]) - 0.7) < 1e-6
    # influence propagates leftward from the controlled boundary (u<0 moves
    # left; positive boundary advects right, so check injection near edge)
    assert np.abs(np.asarray(state.u)[-10:]).max() > 0


def test_godunov_flux_exact_riemann_properties():
    """The default Godunov flux is the exact Riemann solver for f(u)=u²/2:
    (a) for an all-positive state it reduces to pure upwind F=f(u_left);
    (b) at a transonic face (ul<0<ur) the flux is exactly 0 (sonic point
    inside the rarefaction fan) — Rusanov gives -0.5 there instead."""
    env = _env(viscosity=0.0)
    dt, dx = env.config.dt, env.config.dx
    dtdx = dt / dx

    # (a) positive field → upwind
    rng = np.random.default_rng(0)
    u = rng.uniform(0.2, 1.5, 256).astype(np.float32)
    u_new, _ = env._advance(jnp.asarray(u), jnp.zeros(256, jnp.float32),
                            jnp.float32(u[-1]))
    i = np.arange(2, 254)
    expect = u[i] - dtdx * 0.5 * (u[i] ** 2 - u[i - 1] ** 2)
    np.testing.assert_allclose(np.asarray(u_new)[i], expect, rtol=2e-6)

    # (b) transonic jump -1|+1 at face k: F(jump)=0, outer faces F=0.5, so
    # the rarefaction opens symmetrically by 0.5*dtdx on each side
    u = np.where(np.arange(256) < 128, -1.0, 1.0).astype(np.float32)
    u_new, _ = env._advance(jnp.asarray(u), jnp.zeros(256, jnp.float32),
                            jnp.float32(1.0))
    assert abs(float(u_new[127]) - (-1.0 + 0.5 * dtdx)) < 1e-6
    assert abs(float(u_new[128]) - (1.0 - 0.5 * dtdx)) < 1e-6


def test_gym_adapter_burgers():
    import gymnasium as gym
    import pdecontrolgym_jax  # noqa: F401

    env = gym.make(
        "PDEControlGym-Burgers1D",
        T=0.2, dt=1e-4, X=1.0, dx=1.0 / 256,
        reward_class=TunedReward1D(2000),
        normalize=False, sensing_loc="full", control_type="Dirchilet",
        sensing_type=None, sensing_noise_func=lambda s: s,
        limit_pde_state_size=True, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda n: np.sin(np.pi * np.linspace(0, 1, n)).astype(np.float32),
        reset_recirculation_func=lambda n: np.zeros(n, np.float32),
        control_sample_rate=0.01, viscosity=1e-3,
    )
    obs, _ = env.reset()
    assert obs.shape == (256,)
    term = trunc = False
    steps = 0
    while not (term or trunc):
        obs, r, term, trunc, _ = env.step(np.float32(0.0))
        steps += 1
    assert steps == 20
