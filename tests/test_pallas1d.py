"""The Pallas interval kernel (ops/pallas1d) vs the XLA scan path, run in the
Pallas interpreter on the CPU (backend="interpret")."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def _pair(env_cls, cfg, reward):
    xla = env_cls(dataclasses.replace(cfg, backend="xla"), reward)
    pls = env_cls(dataclasses.replace(cfg, backend="interpret"), reward)
    return xla, pls


def _compare(xla, pls, B=8, steps=4, action_fn=None, obs_tol=1e-6):
    keys = jax.random.split(jax.random.key(0), B)
    state_x, obs_x = jax.vmap(xla.init)(keys)
    state_p, obs_p = jax.vmap(pls.init)(keys)
    np.testing.assert_allclose(np.asarray(obs_x), np.asarray(obs_p), atol=0)

    step_x = jax.jit(lambda s, a: xla.step_batch(s, a))
    step_p = jax.jit(lambda s, a: pls.step_batch(s, a))
    rng = np.random.default_rng(0)
    for i in range(steps):
        a = jnp.asarray(
            action_fn(i) if action_fn else rng.uniform(-0.5, 0.5, B), jnp.float32
        )
        state_x, out_x = step_x(state_x, a)
        state_p, out_p = step_p(state_p, a)
        np.testing.assert_allclose(
            np.asarray(out_x.obs), np.asarray(out_p.obs),
            rtol=obs_tol, atol=obs_tol,
        )
        # rewards are differences of norms (cancellation-amplified); the norm
        # itself matches to float32 reassociation noise (~1e-6 relative)
        np.testing.assert_allclose(
            np.asarray(out_x.reward), np.asarray(out_p.reward), rtol=1e-3, atol=1e-3
        )
        np.testing.assert_array_equal(
            np.asarray(out_x.terminated), np.asarray(out_p.terminated)
        )
        np.testing.assert_array_equal(
            np.asarray(state_x.time_index), np.asarray(state_p.time_index)
        )
        np.testing.assert_allclose(
            np.asarray(state_x.bsum), np.asarray(state_p.bsum), rtol=1e-4
        )


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_transport_pallas_matches_xla(control_type):
    cfg = Boundary1DConfig(
        T=0.05, dt=1e-4, X=1.0, dx=1.0 / 128, control_sample_rate=0.01,
        control_type=control_type, limit_pde_state_size=True,
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2)
    _compare(*_pair(TransportEnv, cfg, reward), steps=5)


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_reaction_diffusion_pallas_matches_xla(control_type):
    cfg = ReactionDiffusionConfig(
        T=0.01, dt=1e-5, X=1.0, dx=5e-3, control_sample_rate=1e-3,
        control_type=control_type,
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2)
    _compare(*_pair(ReactionDiffusionEnv, cfg, reward), steps=4)


@pytest.mark.parametrize("batch", [8, 37])
@pytest.mark.parametrize("theta,control_type", [
    (1.0, "Dirchilet"),   # backward Euler: rhs stencil statically dropped
    (0.5, "Dirchilet"),   # Crank-Nicolson
    (0.5, "Neumann"),     # state-dependent boundary read in-kernel
])
def test_reaction_diffusion_implicit_pcr_pallas_matches_xla(
        theta, control_type, batch):
    """The PCR interval kernel (coefficient elimination hoisted to once per
    interval, 9-step rhs-only reduction per sub-step) vs the XLA pcr solver
    — same θ-scheme semantics, fp-association tolerance. A batch of 37 is
    not a multiple of the kernel's env tile, so the padded rows are
    exercised too."""
    cfg = ReactionDiffusionConfig(
        T=0.02, dt=4e-4, X=1.0, dx=1.0 / 256, control_sample_rate=4e-3,
        scheme="implicit", theta=theta, implicit_solver="pcr",
        control_type=control_type,
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2)
    xla, pls = _pair(ReactionDiffusionEnv, cfg, reward)
    assert pls._kernel_spec() is not None
    # the kernel's folded rhs diagonal + identity-row pads reassociate a few
    # f32 ulps per solve vs the XLA pcr (where-guarded shifts, unfolded rhs)
    _compare(xla, pls, B=batch, steps=4, obs_tol=2e-5)


def test_reaction_diffusion_implicit_kernel_matches_thomas():
    """Solver-independence check: the PCR interval kernel against the XLA THOMAS sweeps (a structurally different O(n)
    algorithm) — pins the solve itself, not just the PCR formulation."""
    kw = dict(T=0.02, dt=4e-4, X=1.0, dx=1.0 / 256,
              control_sample_rate=4e-3, scheme="implicit", theta=0.5)
    reward = TunedReward1D(50, -1e3, 3e2)
    thomas_env = ReactionDiffusionEnv(
        ReactionDiffusionConfig(**kw, implicit_solver="thomas",
                                backend="xla"), reward)
    pls = ReactionDiffusionEnv(
        ReactionDiffusionConfig(**kw, implicit_solver="pcr",
                                backend="interpret"), reward)
    _compare(thomas_env, pls, steps=4, obs_tol=2e-5)


def test_reaction_diffusion_implicit_terminal_interval():
    # episode ends mid-interval: the implicit kernel's masked path must
    # freeze finished envs identically to the XLA scan
    cfg = ReactionDiffusionConfig(
        T=0.01, dt=4e-4, X=1.0, dx=1.0 / 256, control_sample_rate=4e-3,
        scheme="implicit", theta=0.5, implicit_solver="pcr",
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2)
    _compare(*_pair(ReactionDiffusionEnv, cfg, reward), steps=4, obs_tol=2e-5)


def test_implicit_thomas_dense_stay_xla():
    # only the pcr solver has a fused kernel; thomas/dense must not build one
    for solver in ("thomas", "dense"):
        cfg = ReactionDiffusionConfig(
            T=0.02, dt=4e-4, X=1.0, dx=1.0 / 256, control_sample_rate=4e-3,
            scheme="implicit", theta=0.5, implicit_solver=solver,
        )
        env = ReactionDiffusionEnv(
            cfg, TunedReward1D(int(round(cfg.T / cfg.dt)))
        )
        assert env._kernel_spec() is None


def test_burgers_pallas_matches_xla():
    cfg = BurgersConfig(
        T=0.1, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
        viscosity=1e-3,
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)))
    _compare(*_pair(BurgersEnv, cfg, reward), steps=4)


def test_burgers_transposed_terminal_interval():
    # 2 full intervals then a terminal one: exercises the kernel's
    # masked path (per-sub-step freeze of finished envs) and its t bookkeeping
    cfg = BurgersConfig(
        T=0.025, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
        viscosity=1e-3,
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)))
    _compare(*_pair(BurgersEnv, cfg, reward), steps=4)


def test_burgers_transposed_neumann_boundary():
    # Neumann control: boundary varies per sub-step -> non-constant bsum
    # accumulation inside the kernel
    cfg = BurgersConfig(
        T=0.1, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
        viscosity=1e-3, control_type="Neumann",
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)))
    _compare(*_pair(BurgersEnv, cfg, reward), steps=3)


def test_burgers_unaligned_state_dim():
    # nx=100 is not a power of two: the kernel zero-pads the state columns
    # to 128 and keeps the pads zero, so norms/rewards stay exact
    cfg = BurgersConfig(
        T=0.1, dt=1e-4, X=1.0, dx=1.0 / 100, control_sample_rate=0.01,
        viscosity=1e-3,
    )
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)))
    _compare(*_pair(BurgersEnv, cfg, reward), steps=2)


def test_pallas_fallback_paths():
    # implicit scheme at a non-power-of-two width (201 points, padded to
    # 256 columns) through the kernel's PCR body
    cfg = ReactionDiffusionConfig(
        T=0.01, dt=1e-4, X=1.0, dx=5e-3, control_sample_rate=1e-3,
        scheme="implicit", backend="interpret",
    )
    env = ReactionDiffusionEnv(cfg, TunedReward1D(100))
    keys = jax.random.split(jax.random.key(0), 4)
    state, obs = jax.vmap(env.init)(keys)
    state, out = jax.jit(lambda s, a: env.step_batch(s, a))(state, jnp.zeros(4))
    assert np.isfinite(np.asarray(out.obs)).all()


def test_rollout_uses_step_batch():
    from pdecontrolgym_jax.parallel.rollout import rollout

    cfg = Boundary1DConfig(
        T=0.05, dt=1e-4, X=1.0, dx=1.0 / 128, control_sample_rate=0.01,
        backend="interpret",
    )
    env = TransportEnv(cfg, TunedReward1D(500, -1e3, 3e2))
    (state, obs), outs = jax.jit(
        lambda k: rollout(env, lambda o, _k: jnp.zeros(o.shape[0]), 8, 7, k)
    )(jax.random.key(3))
    assert outs.reward.shape == (7, 8)
    assert np.asarray(outs.terminated)[4].all()  # 5 steps to terminate, then autoreset


def test_nonfinite_truncation_masking():
    cfg = Boundary1DConfig(
        T=1.0, dt=1e-2, X=1.0, dx=1.0 / 16, control_sample_rate=0.1,
        truncate_on_nonfinite=True, limit_pde_state_size=False,
    )
    env = TransportEnv(cfg, TunedReward1D(100, -1e3, 3e2, lookback=5))
    state, _ = env.init_from(
        np.full(16, np.nan, np.float32), np.zeros(16, np.float32)
    )
    state, out = jax.jit(env.step)(state, jnp.float32(0.0))
    assert bool(out.truncated)
