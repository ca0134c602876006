"""Kernel-level NaN tooling (utils/debug): a deliberately unstable config
surfaces a *useful* error instead of silent NaN propagation (VERDICT round-1
item 9; SURVEY §5 sanitizers)."""

import jax.numpy as jnp
import pytest
from jax.experimental import checkify

from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.tuned import TunedReward1D
from pdecontrolgym_jax.utils.debug import cfl_report, checked_step, checked_step_batch


def _unstable_rd_env():
    # F = dt/dx^2 = 1e-2/2.5e-3 = 4.0 >> 0.5: FTCS blows up within one interval
    cfg = ReactionDiffusionConfig(
        T=10.0, dt=1e-2, X=1.0, dx=0.05, control_sample_rate=1e-1
    )
    reward = TunedReward1D(cfg.nt, -1e3, 3e2)
    return ReactionDiffusionEnv(cfg, reward)


def test_checked_step_surfaces_nan_with_context():
    env = _unstable_rd_env()
    state, _ = env.init_from(
        jnp.ones(env.state_dim), jnp.zeros(env.state_dim)
    )
    step = checked_step(env)
    # the reward's norm reduction can overflow an interval before the raw
    # state does — either way the error names the env and the time index
    with pytest.raises(checkify.JaxRuntimeError,
                       match="ReactionDiffusionEnv: non-finite"):
        for _ in range(50):  # overflow -> inf -> nan within a few intervals
            state, out = step(state, 0.0)


def test_checked_step_clean_config_passes():
    cfg = Boundary1DConfig(T=0.01, dt=1e-4, X=1.0, dx=1e-2,
                           control_sample_rate=1e-3)
    env = TransportEnv(cfg, TunedReward1D(cfg.nt, -1e3, 3e2))
    state, _ = env.init_from(jnp.ones(env.state_dim), jnp.zeros(env.state_dim))
    step = checked_step(env)
    state, out = step(state, 0.5)
    assert bool(jnp.isfinite(out.reward))


def test_checked_step_batch_aggregates():
    env = _unstable_rd_env()
    import jax

    states, _ = jax.vmap(env.init_from)(
        jnp.ones((4, env.state_dim)), jnp.zeros((4, env.state_dim))
    )
    step = checked_step_batch(env)
    with pytest.raises(checkify.JaxRuntimeError, match="non-finite PDE state"):
        for _ in range(50):
            states, outs = step(states, jnp.zeros(4))


def test_cfl_report_flags_unstable_and_names_fix():
    cfg = ReactionDiffusionConfig(T=10.0, dt=1e-2, X=1.0, dx=0.05)
    with pytest.raises(ValueError, match="Fourier"):
        cfl_report(cfg)
    # the error text should point at the implicit scheme escape hatch
    try:
        cfl_report(cfg)
    except ValueError as e:
        assert "implicit" in str(e)


def test_cfl_report_clean_configs():
    ok = cfl_report(Boundary1DConfig(T=5.0, dt=1e-4, dx=1e-2))
    assert all(f.ok for f in ok)
    ok = cfl_report(ReactionDiffusionConfig(T=1.0, dt=1e-5, dx=5e-3))
    assert all(f.ok for f in ok)

    from pdecontrolgym_jax.envs.navier_stokes import NavierStokesConfig

    ok = cfl_report(NavierStokesConfig())
    assert all(f.ok for f in ok)
    with pytest.raises(ValueError, match="diffusion"):
        cfl_report(NavierStokesConfig(dt=1e-1))
