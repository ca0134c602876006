"""Golden-trajectory parity: the JAX transport env vs the actual reference env.

Acceptance bar from BASELINE.json: trajectories and returns comparable against
the reference solvers under fixed seed and identical control sequences, within
FD tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.tuned import TunedReward1D
from pdecontrolgym_jax.agents.backstepping import transport_kernel, transport_control

from reference_loader import load_reference_module

T, DT, DX, X = 1.0, 1e-4, 1e-2, 1.0
NT = int(round(T / DT)) + 1
NX = int(round(X / DX))
RATE = 0.1  # control_sample_rate -> 1000 sub-steps per action


def _beta(nx):
    x = np.linspace(0, 1, nx)
    return (5 * np.cos(7.35 * np.arccos(x))).astype(np.float32)


def _make_reference_env(control_type="Dirchilet", sensing_loc="full", u0=None):
    hyperbolic = load_reference_module(
        "pde_control_gym.src.environments1d.hyperbolic"
    )
    tuned = load_reference_module("pde_control_gym.src.rewards.tuned_reward_1d")
    return hyperbolic.TransportPDE1D(
        T=T,
        dt=DT,
        X=X,
        dx=DX,
        reward_class=tuned.TunedReward1D(int(round(T / DT)), -1e3, 3e2),
        normalize=False,
        sensing_loc=sensing_loc,
        control_type=control_type,
        sensing_type="Dirchilet",
        sensing_noise_func=lambda s: s,
        limit_pde_state_size=True,
        max_state_value=1e10,
        max_control_value=20,
        reset_init_condition_func=lambda nx: u0,
        reset_recirculation_func=_beta,
        control_sample_rate=RATE,
    )


def _make_jax_env(control_type="Dirchilet", sensing_loc="full"):
    cfg = Boundary1DConfig(
        T=T,
        dt=DT,
        X=X,
        dx=DX,
        sensing_loc=sensing_loc,
        control_type=control_type,
        sensing_type="Dirchilet",
        limit_pde_state_size=True,
        max_state_value=1e10,
        max_control_value=20.0,
        control_sample_rate=RATE,
    )
    return TransportEnv(cfg, TunedReward1D(int(round(T / DT)), -1e3, 3e2))


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_open_loop_trajectory_match(control_type):
    rng = np.random.default_rng(0)
    u0 = np.full(NX, 3.0, np.float32)
    controls = rng.uniform(-1.0, 1.0, size=32).astype(np.float32)

    ref = _make_reference_env(control_type=control_type, u0=u0)
    ref_obs, _ = ref.reset()
    ref_traj, ref_rews = [ref_obs], []
    for c in controls:
        obs, r, term, trunc, _ = ref.step(np.float32(c))
        ref_traj.append(obs)
        ref_rews.append(r)
        if term or trunc:
            break

    env = _make_jax_env(control_type=control_type)
    step = jax.jit(env.step)
    state, obs0 = env.init_from(u0, _beta(NX))
    jax_traj, jax_rews = [np.asarray(obs0)], []
    done = False
    for c in controls:
        if done:
            break
        state, out = step(state, jnp.float32(c))
        jax_traj.append(np.asarray(out.obs))
        jax_rews.append(float(out.reward))
        done = bool(out.terminated) or bool(out.truncated)

    assert len(ref_traj) == len(jax_traj)
    for a, b in zip(ref_traj, jax_traj):
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a, b, atol=2e-3 * scale, rtol=0)
    np.testing.assert_allclose(ref_rews, jax_rews, rtol=2e-3, atol=2e-3)


def test_closed_loop_backstepping_match():
    u0 = np.full(NX, 2.0, np.float32)
    spatial = np.linspace(DX, X, NX)
    theta = (5 * np.cos(7.35 * np.arccos(spatial))).astype(np.float32)
    kernel = np.asarray(transport_kernel(jnp.asarray(theta), DX))

    ref = _make_reference_env(u0=u0)
    obs, _ = ref.reset()
    ref_total, term, trunc = 0.0, False, False
    while not (term or trunc):
        action = float(np.dot(kernel, obs) * DX)
        obs, r, term, trunc, _ = ref.step(np.float32(action))
        ref_total += r
    ref_final = obs.copy()

    env = _make_jax_env()
    step = jax.jit(env.step)
    state, obs = env.init_from(u0, _beta(NX))
    jax_total, done = 0.0, False
    while not done:
        action = transport_control(jnp.asarray(kernel), obs, DX)
        state, out = step(state, action)
        obs = out.obs
        jax_total += float(out.reward)
        done = bool(out.terminated) or bool(out.truncated)

    np.testing.assert_allclose(np.asarray(obs), ref_final, atol=1e-3)
    assert abs(ref_total - jax_total) < 0.05 * max(1.0, abs(ref_total))


@pytest.mark.parametrize(
    "sensing_loc,control_type",
    [("collocated", "Dirchilet"), ("collocated", "Neumann"), ("opposite", "Dirchilet")],
)
def test_sensing_variants_match(sensing_loc, control_type):
    u0 = np.full(NX, 1.5, np.float32)
    controls = np.linspace(-0.5, 0.5, 8).astype(np.float32)

    ref = _make_reference_env(control_type=control_type, sensing_loc=sensing_loc, u0=u0)
    ref_obs, _ = ref.reset()
    env = _make_jax_env(control_type=control_type, sensing_loc=sensing_loc)
    step = jax.jit(env.step)
    state, obs0 = env.init_from(u0, _beta(NX))

    np.testing.assert_allclose(np.atleast_1d(ref_obs), np.asarray(obs0), atol=1e-6)
    for c in controls:
        r_obs, r_rew, r_term, r_trunc, _ = ref.step(np.float32(c))
        state, out = step(state, jnp.float32(c))
        np.testing.assert_allclose(
            np.atleast_1d(r_obs), np.asarray(out.obs), atol=2e-3, rtol=1e-3
        )
        assert (bool(out.terminated), bool(out.truncated)) == (r_term, r_trunc)


def test_batched_vmap_rollout():
    """4096-env lockstep batching is the raison d'être — smoke-check shapes
    and per-env independence on a small batch."""
    env = _make_jax_env()
    B = 16
    keys = jax.random.split(jax.random.key(0), B)
    batched_init = jax.jit(jax.vmap(env.init))
    batched_step = jax.jit(jax.vmap(env.step))
    state, obs = batched_init(keys)
    assert obs.shape == (B, NX)
    actions = jnp.linspace(-1, 1, B)
    state, out = batched_step(state, actions)
    assert out.obs.shape == (B, NX)
    assert out.reward.shape == (B,)
    # env 0 must equal an identical single-env rollout
    s0, _ = env.init(keys[0])
    s0, out0 = jax.jit(env.step)(s0, actions[0])
    np.testing.assert_allclose(np.asarray(out.obs[0]), np.asarray(out0.obs), atol=1e-6)


def test_notebook_fixed_ic_golden_values():
    """Deterministic reproduction of the published notebook table
    (HyperbolicPDEExample.ipynb cell 22): T=10, backstepping, fixed ICs.
    Published: u0=1 -> reward 289.84 / sumL2 106.09; u0=10 -> 198.38 / 1060.86."""
    T10 = 10.0
    cfg = Boundary1DConfig(
        T=T10, dt=DT, X=X, dx=DX, control_sample_rate=RATE,
        limit_pde_state_size=True, max_state_value=1e10,
    )
    env = TransportEnv(cfg, TunedReward1D(int(round(T10 / DT)), -1e3, 3e2))
    spatial = np.linspace(DX, X, NX)
    kern = transport_kernel(
        jnp.asarray(5 * np.cos(7.35 * np.arccos(spatial)), jnp.float32), DX
    )

    @jax.jit
    def run(u0):
        state, obs = env.init_from(u0, jnp.asarray(_beta(NX)))

        def body(carry, _):
            state, obs = carry
            a = transport_control(kern, obs, DX)
            state, out = env.step(state, a)
            return (state, out.obs), (out.reward, jnp.linalg.norm(out.obs))

        (_, _), (rews, norms) = jax.lax.scan(body, (state, obs), None, length=100)
        return rews.sum(), norms.sum()

    r1, l2_1 = run(jnp.ones(NX, jnp.float32))
    np.testing.assert_allclose(float(r1), 289.84, atol=0.5)
    np.testing.assert_allclose(float(l2_1), 106.09, rtol=5e-3)
    r10, l2_10 = run(jnp.full(NX, 10.0, jnp.float32))
    np.testing.assert_allclose(float(r10), 198.38, atol=0.5)
    np.testing.assert_allclose(float(l2_10), 1060.86, rtol=5e-3)
