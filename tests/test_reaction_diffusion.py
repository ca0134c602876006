"""Reaction-diffusion parity (explicit FTCS vs reference) and the implicit
implicit tridiagonal path (accuracy vs the heat-equation analytic solution)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_jax.rewards.tuned import TunedReward1D
from pdecontrolgym_jax.agents.backstepping import parabolic_control, parabolic_kernel
from pdecontrolgym_jax.ops.tridiag import pcr, thomas

from reference_loader import load_reference_module

T, DT, DX, X = 0.05, 1e-5, 5e-3, 1.0
NX = int(round(X / DX))  # 200; state dim 201
RATE = 1e-3  # 100 sub-steps per action


def _beta(nx):
    x = np.linspace(0, 1, nx + 1)
    return (50 * np.cos(8 * np.arccos(x))).astype(np.float32)


def _ref_env(u0, control_type="Dirchilet"):
    parabolic = load_reference_module("pde_control_gym.src.environments1d.parabolic")
    tuned = load_reference_module("pde_control_gym.src.rewards.tuned_reward_1d")
    return parabolic.ReactionDiffusionPDE1D(
        T=T, dt=DT, X=X, dx=DX,
        reward_class=tuned.TunedReward1D(int(round(T / DT)), -1e3, 3e2),
        normalize=False, sensing_loc="full", control_type=control_type,
        sensing_type="Neumann", sensing_noise_func=lambda s: s,
        limit_pde_state_size=True, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda nx: u0,
        reset_recirculation_func=_beta,
        control_sample_rate=RATE,
    )


def _jax_env(control_type="Dirchilet", **kw):
    cfg = ReactionDiffusionConfig(
        T=T, dt=DT, X=X, dx=DX, control_type=control_type,
        sensing_type="Neumann", limit_pde_state_size=True,
        control_sample_rate=RATE, **kw,
    )
    return ReactionDiffusionEnv(cfg, TunedReward1D(int(round(T / DT)), -1e3, 3e2))


@pytest.mark.parametrize("control_type", ["Dirchilet", "Neumann"])
def test_explicit_parity(control_type):
    rng = np.random.default_rng(1)
    u0 = np.full(NX + 1, 2.0, np.float32)
    controls = rng.uniform(-0.5, 0.5, size=12).astype(np.float32)

    ref = _ref_env(u0, control_type)
    robs, _ = ref.reset()
    env = _jax_env(control_type)
    step = jax.jit(env.step)
    state, tobs = env.init_from(u0, _beta(NX))
    np.testing.assert_allclose(robs, np.asarray(tobs), atol=1e-6)

    for c in controls:
        robs, rrew, rterm, rtrunc, _ = ref.step(np.float32(c))
        state, out = step(state, jnp.float32(c))
        scale = max(1.0, np.abs(robs).max())
        np.testing.assert_allclose(robs, np.asarray(out.obs), atol=2e-3 * scale)
        np.testing.assert_allclose(rrew, float(out.reward), rtol=5e-3, atol=5e-3)
        assert (rterm, rtrunc) == (bool(out.terminated), bool(out.truncated))


def test_closed_loop_goursat_backstepping_stabilizes_and_matches():
    u0 = np.full(NX + 1, 4.0, np.float32)
    spatial = np.linspace(DX, X, NX + 1)
    beta_k = (50 * np.cos(8 * np.arccos(spatial))).astype(np.float64)
    krow = np.asarray(parabolic_kernel(jnp.asarray(beta_k), DX))

    ref = _ref_env(u0)
    obs, _ = ref.reset()
    ref_total, term, trunc = 0.0, False, False
    while not (term or trunc):
        a = float(np.sum(krow[: len(obs) - 1] * obs[:-1]) * DX)
        obs, r, term, trunc, _ = ref.step(np.float32(a))
        ref_total += r

    env = _jax_env()
    step = jax.jit(env.step)
    state, tobs = env.init_from(u0, _beta(NX))
    jax_total, done = 0.0, False
    while not done:
        a = parabolic_control(jnp.asarray(krow, jnp.float32), tobs, DX)
        state, out = step(state, a)
        tobs = out.obs
        jax_total += float(out.reward)
        done = bool(out.terminated) or bool(out.truncated)

    np.testing.assert_allclose(np.asarray(tobs), obs, atol=2e-3 * max(1.0, np.abs(obs).max()))
    assert abs(ref_total - jax_total) < 0.05 * max(1.0, abs(ref_total))


def test_implicit_matches_heat_equation_analytics():
    """β=0, u0=sin(πx), zero control: u(x,t)=exp(−π²t)·sin(πx)."""
    nx = 200
    cfg = ReactionDiffusionConfig(
        T=0.05, dt=1e-4, X=1.0, dx=5e-3, control_sample_rate=0.01,
        scheme="implicit", theta=0.5,
    )
    env = ReactionDiffusionEnv(cfg, TunedReward1D(500))
    x = np.linspace(0, 1, nx + 1)
    u0 = np.sin(np.pi * x).astype(np.float32)
    state, _ = env.init_from(u0, np.zeros(nx + 1, np.float32))
    step = jax.jit(env.step)
    for _ in range(5):  # 5 * 100 sub-steps * 1e-4 = t = 0.05
        state, out = step(state, jnp.float32(0.0))
    expected = np.exp(-np.pi**2 * 0.05) * np.sin(np.pi * x)
    np.testing.assert_allclose(np.asarray(state.u), expected, atol=2e-3)


def test_implicit_stable_where_explicit_blows_up():
    """dt 40x beyond the FTCS stability bound: explicit diverges, BE doesn't."""
    kw = dict(T=0.1, dt=5e-4, X=1.0, dx=5e-3, control_sample_rate=5e-3)
    x = np.linspace(0, 1, 201)
    u0 = np.sin(np.pi * x).astype(np.float32)
    beta = np.zeros(201, np.float32)

    env_i = ReactionDiffusionEnv(
        ReactionDiffusionConfig(**kw, scheme="implicit", theta=1.0), TunedReward1D(200)
    )
    state, _ = env_i.init_from(u0, beta)
    step = jax.jit(env_i.step)
    for _ in range(3):
        state, _ = step(state, jnp.float32(0.0))
    assert np.isfinite(np.asarray(state.u)).all()
    assert np.abs(np.asarray(state.u)).max() < 1.0

    env_e = ReactionDiffusionEnv(
        ReactionDiffusionConfig(**kw, scheme="explicit"), TunedReward1D(200)
    )
    state, _ = env_e.init_from(u0, beta)
    step = jax.jit(env_e.step)
    for _ in range(3):
        state, _ = step(state, jnp.float32(0.0))
    assert not np.isfinite(np.asarray(state.u)).all() or np.abs(np.asarray(state.u)).max() > 1e3


def test_dense_propagator_matches_thomas():
    """implicit_solver='dense' (precomputed affine propagator, one matmul per
    sub-step) reproduces the per-sub-step Thomas solve over full control
    intervals, for both control types."""
    for control_type in ("Dirchilet", "Neumann"):
        kw = dict(T=0.1, dt=4e-4, X=1.0, dx=5e-3, control_sample_rate=4e-3,
                  scheme="implicit", theta=0.5, control_type=control_type)
        env_t = ReactionDiffusionEnv(
            ReactionDiffusionConfig(**kw, implicit_solver="thomas"),
            TunedReward1D(250))
        env_d = ReactionDiffusionEnv(
            ReactionDiffusionConfig(**kw, implicit_solver="dense"),
            TunedReward1D(250))
        # "auto" resolves to PCR (per-env-β-safe measured winner)
        env_p = ReactionDiffusionEnv(
            ReactionDiffusionConfig(**kw), TunedReward1D(250))
        assert env_p._solver == "pcr"
        key = jax.random.key(3)
        st_t, _ = env_t.init(key)
        st_d, _ = env_d.init(key)
        st_p, _ = env_p.init(key)
        step_t, step_d, step_p = (
            jax.jit(env_t.step), jax.jit(env_d.step), jax.jit(env_p.step))
        for i in range(4):
            a = jnp.float32(0.3 * (i - 1))
            st_t, out_t = step_t(st_t, a)
            st_d, out_d = step_d(st_d, a)
            st_p, out_p = step_p(st_p, a)
            scale = np.abs(np.asarray(st_t.u)).max()
            np.testing.assert_allclose(
                np.asarray(st_d.u), np.asarray(st_t.u),
                atol=1e-4 * max(1.0, scale),
            )
            np.testing.assert_allclose(
                np.asarray(st_p.u), np.asarray(st_t.u),
                atol=1e-4 * max(1.0, scale),
            )
            np.testing.assert_allclose(
                np.asarray(out_d.reward), np.asarray(out_t.reward),
                rtol=1e-3, atol=1e-3,
            )
            np.testing.assert_allclose(
                np.asarray(out_p.reward), np.asarray(out_t.reward),
                rtol=1e-3, atol=1e-3,
            )


def test_dense_propagator_rejects_random_beta():
    cfg = ReactionDiffusionConfig(
        T=0.1, dt=4e-4, X=1.0, dx=5e-3, control_sample_rate=4e-3,
        scheme="implicit", implicit_solver="dense",
    )

    def random_beta_ic(key):
        u0 = jnp.ones(201, jnp.float32)
        return u0, jax.random.uniform(key, (201,), jnp.float32)

    with pytest.raises(ValueError, match="env-invariant beta"):
        ReactionDiffusionEnv(cfg, TunedReward1D(250),
                             ic_sampler=random_beta_ic)


def test_tridiag_solvers_agree_with_dense():
    rng = np.random.default_rng(3)
    n, batch = 64, 5
    lower = rng.uniform(0.1, 1.0, (batch, n))
    upper = rng.uniform(0.1, 1.0, (batch, n))
    diag = 4.0 + rng.uniform(0, 1, (batch, n))  # diagonally dominant
    rhs = rng.normal(size=(batch, n))
    x_thomas = np.asarray(thomas(lower, diag, upper, rhs))
    x_pcr = np.asarray(pcr(lower, diag, upper, rhs))
    for b in range(batch):
        A = np.diag(diag[b]) + np.diag(lower[b][1:], -1) + np.diag(upper[b][:-1], 1)
        expect = np.linalg.solve(A, rhs[b])
        np.testing.assert_allclose(x_thomas[b], expect, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(x_pcr[b], expect, rtol=1e-6, atol=1e-8)


def test_notebook_fixed_ic_golden_values():
    """Deterministic reproduction of the published parabolic notebook table
    (ParabolicPDEExample.ipynb cell 23): backstepping, fixed ICs, T=1.
    Published rewards: u0=1 -> 299.82; u0=10 -> 298.23 (ours match to 0.2%;
    the sumL2 column lands within 3% of 1275.44 / 12754.40)."""
    T1 = 1.0
    cfg = ReactionDiffusionConfig(
        T=T1, dt=DT, X=X, dx=DX, control_sample_rate=RATE,
        limit_pde_state_size=True, max_state_value=1e10,
    )
    env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(T1 / DT)), -1e3, 3e2))
    spatial = np.linspace(DX, X, NX + 1)
    krow = parabolic_kernel(
        jnp.asarray(50 * np.cos(8 * np.arccos(spatial)), jnp.float32), DX
    )

    @jax.jit
    def run(u0):
        state, obs = env.init_from(u0, jnp.asarray(_beta(NX)))

        def body(carry, _):
            state, obs = carry
            a = parabolic_control(krow, obs, DX)
            state, out = env.step(state, a)
            return (state, out.obs), (out.reward, jnp.linalg.norm(out.obs))

        (_, _), (rews, norms) = jax.lax.scan(body, (state, obs), None, length=1000)
        return rews.sum(), norms.sum()

    r1, l2_1 = run(jnp.ones(NX + 1, jnp.float32))
    np.testing.assert_allclose(float(r1), 299.82, atol=1.0)
    np.testing.assert_allclose(float(l2_1), 1275.44, rtol=0.05)
    r10, l2_10 = run(jnp.full(NX + 1, 10.0, jnp.float32))
    np.testing.assert_allclose(float(r10), 298.23, atol=1.0)
    np.testing.assert_allclose(float(l2_10), 12754.40, rtol=0.05)
