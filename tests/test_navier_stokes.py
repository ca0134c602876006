"""2D Navier-Stokes parity vs the reference env (f64 oracle, 21x21 grid)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_jax.rewards.ns import NSReward

from reference_loader import load_reference_module

T, DT = 0.05, 1e-3
DX = DY = 0.05
NT = int(round(T / DT))
N = 21

BC = {
    "upper": ["Controllable", "Dirchilet"],
    "lower": ["Dirchilet", "Dirchilet"],
    "left": ["Dirchilet", "Dirchilet"],
    "right": ["Dirchilet", "Dirchilet"],
}


def _refs():
    rng = np.random.default_rng(11)
    U_ref = rng.normal(size=(NT, N, N, 2)) * 0.1
    action_ref = 2.0 * np.ones(NT)
    return U_ref, action_ref


def _ic():
    return (
        1.5 * np.ones((N, N)),
        -0.5 * np.ones((N, N)),
        0.25 * np.ones((N, N)),
    )


def _ref_env(U_ref, action_ref, iters=2000):
    ns = load_reference_module("pde_control_gym.src.environments2d.navier_stokes2D")
    rew = load_reference_module("pde_control_gym.src.rewards.ns_reward")
    return ns.NavierStokes2D(
        T=T, dt=DT, X=1.0, dx=DX, Y=1.0, dy=DY, action_dim=1,
        reward_class=rew.NSReward(0.1), normalize=False,
        reset_init_condition_func=lambda X: _ic(),
        boundary_condition=BC,
        U_ref=U_ref, action_ref=action_ref,
        maximum_pressure_iteration=iters,
    )


def _jax_env(U_ref, action_ref, iters=2000):
    cfg = NavierStokesConfig(
        T=T, dt=DT, X=1.0, dx=DX, Y=1.0, dy=DY, action_dim=1,
        maximum_pressure_iteration=iters,
        boundary_condition=freeze_boundary_condition(BC),
        dtype=jnp.float64,
    )
    return NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref)


@pytest.mark.parametrize("iters", [60, 2000])
def test_open_loop_parity(iters):
    U_ref, action_ref = _refs()
    ref = _ref_env(U_ref, action_ref, iters)
    robs, _ = ref.reset()

    env = _jax_env(U_ref, action_ref, iters)
    u0, v0, p0 = _ic()
    step = jax.jit(env.step)
    state, tobs = env.init_from(u0, v0, p0)
    np.testing.assert_allclose(robs, np.asarray(tobs), atol=1e-12)

    rng = np.random.default_rng(2)
    steps = 6 if iters == 2000 else NT - 1
    for i in range(steps):
        a = rng.uniform(1.0, 3.0)
        robs, rrew, rterm, rtrunc, _ = ref.step(a)
        state, out = step(state, jnp.asarray([a]))
        np.testing.assert_allclose(robs, np.asarray(out.obs), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(rrew, float(out.reward), rtol=1e-9)
        assert rterm == bool(out.terminated)
    if iters != 2000:
        assert rterm  # ran to the horizon


def test_stability_guard_matches_reference():
    U_ref, action_ref = _refs()
    with pytest.raises(RuntimeError, match="Stability is not guarenteed"):
        _jax_env(U_ref, action_ref).__class__(
            NavierStokesConfig(
                dt=0.1, boundary_condition=freeze_boundary_condition(BC)
            ),
            NSReward(0.1), U_ref, action_ref,
        )


def test_gym_adapter_matches_reference_and_exposes_solver():
    import gymnasium as gym
    import pdecontrolgym_jax  # noqa: F401
    from pdecontrolgym_jax.rewards import ns as ns_rewards

    U_ref, action_ref = _refs()
    env = gym.make(
        "PDEControlGym-NavierStokes2D",
        T=T, dt=DT, X=1.0, dx=DX, Y=1.0, dy=DY, action_dim=1,
        reward_class=ns_rewards.NSReward(0.1), normalize=False,
        reset_init_condition_func=lambda X: _ic(),
        boundary_condition=BC, U_ref=U_ref, action_ref=action_ref,
        maximum_pressure_iteration=80,
    ).unwrapped
    ref = _ref_env(U_ref, action_ref, iters=80)
    robs, _ = ref.reset()
    tobs, _ = env.reset()
    np.testing.assert_allclose(robs, tobs, atol=1e-12)
    for i in range(4):
        robs, rrew, *_ = ref.step(2.0)
        tobs, trew, *_ = env.step(np.array([2.0]))
        np.testing.assert_allclose(robs, tobs, rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(rrew, trew, rtol=1e-9)
    # attributes the adjoint-optimization example touches
    np.testing.assert_allclose(env.u, ref.u, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(env.U[: env.time_index + 1],
                               ref.U[: ref.time_index + 1], rtol=1e-9, atol=1e-10)
    p = env.solve_pressure(env.u, env.v, env.p)
    p_ref = ref.solve_pressure(ref.u.copy(), ref.v.copy(), ref.p.copy())
    np.testing.assert_allclose(p, p_ref, rtol=1e-9, atol=1e-10)


def test_batched_vmap_ns():
    U_ref, action_ref = _refs()
    env = _jax_env(U_ref, action_ref, iters=40)
    B = 4
    keys = jax.random.split(jax.random.key(0), B)
    state, obs = jax.jit(jax.vmap(env.init))(keys)
    assert obs.shape == (B, N, N, 2)
    actions = jnp.linspace(1.0, 2.0, B)[:, None]
    state, out = jax.jit(jax.vmap(env.step))(state, actions)
    assert out.obs.shape == (B, N, N, 2)
    assert np.isfinite(np.asarray(out.reward)).all()


def test_flat_pressure_layout_matches_grid():
    from pdecontrolgym_jax.ops.poisson2d import jacobi_pressure, jacobi_pressure_flat

    rng = np.random.default_rng(7)
    u = rng.normal(size=(3, 21, 21))
    v = rng.normal(size=(3, 21, 21))
    p = rng.normal(size=(3, 21, 21))
    a = np.asarray(jacobi_pressure(u, v, p, 0.05, 0.05, 1e-3, 1.0, 150))
    b = np.asarray(jacobi_pressure_flat(u, v, p, 0.05, 0.05, 1e-3, 1.0, 150))
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)

    # full env step equality under the flat layout
    U_ref, action_ref = _refs()
    env_g = _jax_env(U_ref, action_ref, iters=80)
    import dataclasses
    env_f = NavierStokesEnv(
        dataclasses.replace(env_g.config, pressure_layout="flat"),
        env_g.reward, U_ref, action_ref,
    )
    u0, v0, p0 = _ic()
    sg, og = env_g.init_from(u0, v0, p0)
    sf, of = env_f.init_from(u0, v0, p0)
    for _ in range(3):
        sg, outg = jax.jit(env_g.step)(sg, jnp.asarray([2.0]))
        sf, outf = jax.jit(env_f.step)(sf, jnp.asarray([2.0]))
    np.testing.assert_allclose(np.asarray(outg.obs), np.asarray(outf.obs), rtol=1e-12)


@pytest.mark.parametrize("iters", [7, 2000])
def test_matpow_pressure_matches_jacobi(iters):
    """The precomputed affine-map solver reproduces the exact K-sweep Jacobi
    result (finite-iteration truncation error included) to ~1e-12 at f64."""
    from pdecontrolgym_jax.ops.poisson2d import (
        jacobi_pressure,
        matpow_pressure,
        matpow_pressure_setup,
    )

    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.normal(size=(3, N, N)))
    v = jnp.asarray(rng.normal(size=(3, N, N)))
    p = jnp.asarray(rng.normal(size=(3, N, N)))
    a = np.asarray(jacobi_pressure(u, v, p, DX, DY, DT, 1.0, iters))
    mats = matpow_pressure_setup(N, N, DX, DY, iters, jnp.float64)
    b = np.asarray(matpow_pressure(u, v, p, DX, DY, DT, 1.0, mats))
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_matpow_env_matches_parity_mode():
    """Full env steps under pressure_solver='matpow' equal the 2000-iteration
    Jacobi parity mode at rtol 1e-9 (the reference-parity tolerance) — the
    matpow solve IS the parity solve, collapsed to two matmuls."""
    import dataclasses

    U_ref, action_ref = _refs()
    env_j = _jax_env(U_ref, action_ref, iters=2000)
    env_m = NavierStokesEnv(
        dataclasses.replace(env_j.config, pressure_solver="matpow"),
        env_j.reward, U_ref, action_ref,
    )
    u0, v0, p0 = _ic()
    sj, _ = env_j.init_from(u0, v0, p0)
    sm, _ = env_m.init_from(u0, v0, p0)
    stepj = jax.jit(env_j.step)
    stepm = jax.jit(env_m.step)
    for _ in range(6):
        sj, outj = stepj(sj, jnp.asarray([2.0]))
        sm, outm = stepm(sm, jnp.asarray([2.0]))
        np.testing.assert_allclose(
            np.asarray(outm.obs), np.asarray(outj.obs), rtol=1e-9, atol=1e-10
        )
        np.testing.assert_allclose(
            float(outm.reward), float(outj.reward), rtol=1e-9
        )


def test_direct_pressure_matches_converged_jacobi():
    """The DCT-II spectral solve is the exact fixed point of the reference's
    Jacobi sweep: it matches a (effectively) converged Jacobi run to ~1e-10
    and is invariant under one further sweep (modulo the singular constant
    mode, which only drifts the mean — ∇p is what the corrector uses)."""
    from pdecontrolgym_jax.ops.poisson2d import (
        direct_pressure,
        direct_pressure_setup,
        jacobi_pressure,
    )

    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=(21, 21)))
    v = jnp.asarray(rng.normal(size=(21, 21)))
    p0 = jnp.zeros((21, 21))
    pj = jacobi_pressure(u, v, p0, 0.05, 0.05, 1e-3, 1.0, 200_000)
    basis = direct_pressure_setup(21, 21, jnp.float64)
    pd = direct_pressure(u, v, p0, 0.05, 0.05, 1e-3, 1.0, basis)

    pj0 = pj - pj[1:-1, 1:-1].mean()
    pd0 = pd - pd[1:-1, 1:-1].mean()
    np.testing.assert_allclose(np.asarray(pj0), np.asarray(pd0), atol=1e-9)

    # sweep invariance: one more Jacobi iteration starting from the direct
    # solution changes nothing (up to the mean mode)
    ps = jacobi_pressure(u, v, pd, 0.05, 0.05, 1e-3, 1.0, 1)
    ps0 = ps - ps[1:-1, 1:-1].mean()
    np.testing.assert_allclose(np.asarray(ps0), np.asarray(pd0), atol=1e-11)


def test_direct_solver_env_trajectory_close_to_parity_mode():
    """Full NS episodes under pressure_solver='direct' track the 2000-iter
    parity mode: the direct solve is *more* converged, so velocity fields stay
    within the Jacobi truncation error."""
    import dataclasses

    U_ref, action_ref = _refs()
    env_j = _jax_env(U_ref, action_ref, iters=2000)
    env_d = NavierStokesEnv(
        dataclasses.replace(env_j.config, pressure_solver="direct"),
        env_j.reward, U_ref, action_ref,
    )
    u0, v0, p0 = _ic()
    sj, _ = env_j.init_from(u0, v0, p0)
    sd, _ = env_d.init_from(u0, v0, p0)
    stepj = jax.jit(env_j.step)
    stepd = jax.jit(env_d.step)
    for _ in range(10):
        sj, outj = stepj(sj, jnp.asarray([2.0]))
        sd, outd = stepd(sd, jnp.asarray([2.0]))
    np.testing.assert_allclose(
        np.asarray(outd.obs), np.asarray(outj.obs), rtol=2e-3, atol=2e-4
    )
    assert abs(float(outd.reward) - float(outj.reward)) < 1e-3 * max(
        1.0, abs(float(outj.reward))
    )


NEUMANN_BC = {
    "upper": ["Controllable", "Dirchilet"],
    "lower": ["Neumann", "Neumann"],
    "left": ["Neumann", "Dirchilet"],
    "right": ["Dirchilet", "Neumann"],
}


def _direct_env(bc, n=16):
    cfg = NavierStokesConfig(
        T=0.02, dt=1e-3, X=1.0, dx=1.0 / (n - 1), Y=1.0, dy=1.0 / (n - 1),
        viscosity=0.05, dtype=jnp.float32, pressure_solver="direct",
        boundary_condition=freeze_boundary_condition(bc),
    )
    rng = np.random.default_rng(3)
    U_ref = rng.normal(size=(cfg.nt, n, n, 2)).astype(np.float32) * 0.1
    return NavierStokesEnv(cfg, NSReward(0.1), U_ref,
                           np.linspace(1.0, 2.0, cfg.nt).astype(np.float32))


@pytest.mark.parametrize("bc", [BC, NEUMANN_BC], ids=["dirichlet", "neumann"])
def test_step_batch_matches_vmap_step(bc):
    """The batched step (shared tracking-target row) equals vmap(step) for
    both boundary-condition families."""
    env = _direct_env(bc)
    keys = jax.random.split(jax.random.key(4), 3)
    sb, _ = jax.vmap(env.init)(keys)
    sv = sb
    actions = jnp.asarray([[0.5], [1.5], [-1.0]], jnp.float32)
    for _ in range(3):
        sb, ob = jax.jit(env.step_batch)(sb, actions)
        sv, ov = jax.jit(jax.vmap(env.step))(sv, actions)
        for a, b in zip(jax.tree_util.tree_leaves((sb, ob.obs, ob.reward)),
                        jax.tree_util.tree_leaves((sv, ov.obs, ov.reward))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(ob.terminated),
                                      np.asarray(ov.terminated))


def test_grad_through_batched_step():
    """jax.grad flows through the batched XLA step (the differentiable path
    ns_gradient_optimization uses) and equals the gradient through
    vmap(step)."""
    env = _direct_env(BC)
    keys = jax.random.split(jax.random.key(5), 2)
    s0, _ = jax.vmap(env.init)(keys)

    def loss(actions, step):
        s, out = step(s0, actions)
        s, out2 = step(s, actions)
        return out.reward.sum() + out2.reward.sum() + jnp.sum(s.u ** 2)

    a = jnp.asarray([[1.0], [0.3]], jnp.float32)
    g_batch = jax.grad(loss)(a, env.step_batch)
    g_vmap = jax.grad(loss)(a, jax.vmap(env.step))
    assert np.isfinite(np.asarray(g_batch)).all()
    assert np.abs(np.asarray(g_batch)).sum() > 0
    np.testing.assert_allclose(np.asarray(g_batch), np.asarray(g_vmap),
                               rtol=1e-5, atol=1e-6)


def test_ppo_train_step_on_ns():
    """One PPO train step with the policy consuming flattened NS frames."""
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.envs.wrappers import FlatObsEnv

    env = FlatObsEnv(_direct_env(BC))
    trainer = PPOTrainer(env, PPOConfig(num_envs=4, num_steps=4,
                                        num_epochs=1, num_minibatches=2,
                                        hidden=(16, 16)))
    runner = trainer.init(jax.random.key(0))
    p0 = jax.tree_util.tree_leaves(runner.params)
    runner, metrics = trainer.make_train_step()(runner)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["mean_reward"]))
    p1 = jax.tree_util.tree_leaves(runner.params)
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(p0, p1))
