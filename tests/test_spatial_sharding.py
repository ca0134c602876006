"""Halo-exchange spatially-sharded transport vs the single-device env."""

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.parallel.spatial import make_spatial_transport_interval, spatial_mesh
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def test_spatially_sharded_interval_matches_single_device():
    assert jax.device_count() >= 8
    mesh = spatial_mesh(jax.devices()[:8])
    nx, dt, dx, S = 256, 1e-4, 1.0 / 256, 100

    cfg = Boundary1DConfig(T=1.0, dt=dt, X=1.0, dx=dx, control_sample_rate=S * dt)
    env = TransportEnv(cfg, TunedReward1D(10000, lookback=50))

    rng = np.random.default_rng(0)
    u0 = rng.uniform(0.5, 2.0, nx).astype(np.float32)
    beta = rng.uniform(-1.0, 1.0, nx).astype(np.float32)
    control = np.float32(0.37)

    # single-device reference
    state, _ = env.init_from(u0, beta)
    state, _ = jax.jit(env.step)(state, jnp.float32(control))
    expected = np.asarray(state.u)

    # spatially sharded (8 slabs of 32 points, ppermute halos)
    fn = make_spatial_transport_interval(mesh, dt, dx, S)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("x"))
    u_sharded = jax.device_put(jnp.asarray(u0), sh)
    beta_sharded = jax.device_put(jnp.asarray(beta), sh)
    result = np.asarray(fn(u_sharded, beta_sharded, jnp.float32(control)))

    np.testing.assert_allclose(result, expected, rtol=1e-6, atol=1e-6)


def test_spatially_sharded_episode_matches_env_rewards():
    """Full closed-loop backstepping episode on the sharded state reproduces
    the single-device env's TunedReward1D sequence (the sharded norms/dots
    are psum-reductions, so tolerance covers fp reassociation)."""
    from pdecontrolgym_jax.agents.backstepping import transport_kernel
    from pdecontrolgym_jax.parallel.spatial import make_spatial_transport_episode
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.device_count() >= 8
    mesh = spatial_mesh(jax.devices()[:8])
    nx, dt, dx = 256, 1e-4, 1.0 / 256
    cfg = Boundary1DConfig(T=2.0, dt=dt, X=1.0, dx=dx, control_sample_rate=0.1)
    S, nt = cfg.sample_rate, cfg.nt  # 1000 sub-steps/interval, 20 intervals
    env = TransportEnv(cfg, TunedReward1D(nt, -1e3, 3e2))

    spatial = np.linspace(dx, 1.0, nx)
    theta = (5 * np.cos(7.35 * np.arccos(np.clip(spatial, -1, 1)))).astype(np.float32)
    kern = transport_kernel(jnp.asarray(theta), dx)
    rng = np.random.default_rng(1)
    u0 = rng.uniform(1.0, 5.0, nx).astype(np.float32)
    beta = theta  # the plant the kernel stabilizes

    # single-device closed loop
    @jax.jit
    def run_env():
        state, obs = env.init_from(jnp.asarray(u0), jnp.asarray(beta))

        def body(carry, _):
            state, obs = carry
            state, out = env.step(state, (obs @ kern) * dx)
            return (state, out.obs), out.reward

        (state, _), rewards = jax.lax.scan(
            body, (state, obs), None, length=(nt - 1) // S)
        return rewards, state.u

    expected_r, expected_u = run_env()

    fn = make_spatial_transport_episode(mesh, dt=dt, dx=dx, sample_rate=S,
                                        nt=nt)
    sh = NamedSharding(mesh, P("x"))
    rewards, u_final = fn(jax.device_put(jnp.asarray(u0), sh),
                          jax.device_put(jnp.asarray(beta), sh),
                          jax.device_put(jnp.asarray(kern), sh))

    np.testing.assert_allclose(np.asarray(rewards), np.asarray(expected_r),
                               rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(np.asarray(u_final), np.asarray(expected_u),
                               rtol=1e-3, atol=1e-4)
    # the terminal interval actually collected the stabilization bonus
    # (‖u(T)‖ ≈ 8 < 20 after 20 intervals → ~249 on both paths)
    assert float(rewards[-1]) > 200.0
    assert float(expected_r[-1]) > 200.0


def test_spatially_sharded_ns_step_matches_single_device():
    """2D slab decomposition (rows over the mesh, one-row ppermute halos per
    stencil/Jacobi sweep) reproduces the single-device NS projection step
    exactly, including the sequential Neumann pressure-edge corner chain."""
    from pdecontrolgym_jax.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
    )
    from pdecontrolgym_jax.parallel.spatial import make_spatial_ns_step
    from pdecontrolgym_jax.rewards.ns import NSReward

    assert jax.device_count() >= 8
    mesh = spatial_mesh(jax.devices()[:8])

    n = 16
    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Neumann", "Dirchilet"],
        "right": ["Dirchilet", "Neumann"],
    })
    cfg = NavierStokesConfig(
        T=0.02, dt=1e-3, X=1.0, dx=1.0 / (n - 1), Y=1.0, dy=1.0 / (n - 1),
        boundary_condition=bc, dtype=jnp.float64, viscosity=0.05,
        pressure_solver="jacobi", maximum_pressure_iteration=25,
    )
    env = NavierStokesEnv(
        cfg, NSReward(0.1),
        np.zeros((cfg.nt, n, n, 2)), np.zeros(cfg.nt),
    )
    rng = np.random.default_rng(1)
    u = rng.normal(size=(n, n))
    v = rng.normal(size=(n, n))
    p = rng.normal(size=(n, n))
    action = np.float64(1.5)

    # single-device reference: three env steps
    state, _ = env.init_from(u, v, p)
    stepf = jax.jit(env.step)
    for _ in range(3):
        state, _ = stepf(state, jnp.float64(action))

    # slab-sharded: same three steps
    sharded = make_spatial_ns_step(
        mesh, dx=cfg.dx, dy=cfg.dy, dt=cfg.dt, viscosity=cfg.viscosity,
        density=cfg.density, iters=cfg.maximum_pressure_iteration,
        boundary_condition=cfg.boundary_condition, ny=n,
    )
    us, vs, ps = jnp.asarray(u), jnp.asarray(v), jnp.asarray(p)
    for _ in range(3):
        us, vs, ps = sharded(us, vs, ps, jnp.float64(action))

    np.testing.assert_allclose(np.asarray(us), np.asarray(state.u), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(vs), np.asarray(state.v), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ps), np.asarray(state.p), rtol=1e-12, atol=1e-12)


# -- public make_sharded_env factory (GSPMD auto-partitioned) ----------------


def test_make_sharded_env_transport_rollout_matches_unsharded():
    """The PUBLIC spatial-sharding path: wrap a transport env with
    make_sharded_env over an (env=4, x=2) mesh and run it through the normal
    parallel.rollout API — results must match the unsharded rollout (XLA's
    SPMD partitioner only reassociates reductions, so fp tolerance)."""
    from pdecontrolgym_jax.parallel.rollout import rollout
    from pdecontrolgym_jax.parallel.spatial import env_spatial_mesh, make_sharded_env

    cfg = Boundary1DConfig(
        T=0.05, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
        backend="xla",
    )
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))
    mesh = env_spatial_mesh(spatial_shards=2)
    senv = make_sharded_env(env, mesh)
    assert senv.state_dim == env.state_dim  # attribute delegation

    policy = lambda obs, key: 0.1 * obs[:, :1] + 0.01 * jax.random.uniform(
        key, (obs.shape[0], 1))
    key = jax.random.key(3)
    run_s = jax.jit(lambda k: rollout(senv, policy, 8, 4, k))
    run_u = jax.jit(lambda k: rollout(env, policy, 8, 4, k))
    (ss, os_), outs_s = run_s(key)
    (su, ou), outs_u = run_u(key)
    np.testing.assert_allclose(np.asarray(ss.u), np.asarray(su.u),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(outs_s.reward),
                               np.asarray(outs_u.reward), rtol=1e-4, atol=1e-4)
    # the state really is laid out over both mesh axes
    sh = ss.u.sharding
    assert sh.spec == jax.sharding.PartitionSpec("env", "x"), sh


def test_make_sharded_env_ns_rollout_matches_unsharded():
    from pdecontrolgym_jax.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
    )
    from pdecontrolgym_jax.parallel.rollout import rollout
    from pdecontrolgym_jax.parallel.spatial import env_spatial_mesh, make_sharded_env
    from pdecontrolgym_jax.rewards.ns import NSReward

    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"],
        "right": ["Dirchilet", "Dirchilet"],
    })
    n = 8
    cfg = NavierStokesConfig(
        T=6e-3, dt=1e-3, X=1.0, dx=1.0 / (n - 1), Y=1.0, dy=1.0 / (n - 1),
        viscosity=0.02, dtype=jnp.float32, pressure_solver="direct",
        boundary_condition=bc,
    )
    env = NavierStokesEnv(
        cfg, NSReward(0.1),
        jnp.zeros((cfg.nt, cfg.ny, cfg.nx, 2), cfg.dtype),
        jnp.zeros(cfg.nt, cfg.dtype),
    )
    mesh = env_spatial_mesh(spatial_shards=4)  # (env=2, x=4), rows split 2 each
    senv = make_sharded_env(env, mesh)
    policy = lambda obs, key: jnp.full(obs.shape[:1] + (1,), 1.5)
    key = jax.random.key(5)
    run_s = jax.jit(lambda k: rollout(senv, policy, 4, 3, k))
    run_u = jax.jit(lambda k: rollout(env, policy, 4, 3, k))
    (ss, _), outs_s = run_s(key)
    (su, _), outs_u = run_u(key)
    np.testing.assert_allclose(np.asarray(ss.u), np.asarray(su.u),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ss.p), np.asarray(su.p),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(outs_s.reward),
                               np.asarray(outs_u.reward), rtol=1e-5, atol=1e-6)
    # trailing Nones are normalized away by jax
    assert tuple(ss.u.sharding.spec) [:2] == ("env", "x")


def test_make_sharded_env_rejects_pallas_backends():
    import pytest as _pytest

    from pdecontrolgym_jax.parallel.spatial import env_spatial_mesh, make_sharded_env

    cfg = Boundary1DConfig(
        T=0.05, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
        backend="pallas",
    )
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))
    with _pytest.raises(ValueError, match="xla"):
        make_sharded_env(env, env_spatial_mesh(spatial_shards=2))


def test_make_sharded_env_through_vector_adapter():
    """The gymnasium VectorEnv adapter accepts a spatially sharded env."""
    from pdecontrolgym_jax.compat.vector import PDEVectorEnv
    from pdecontrolgym_jax.parallel.spatial import env_spatial_mesh, make_sharded_env

    cfg = Boundary1DConfig(
        T=0.05, dt=1e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
        backend="xla",
    )
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))
    senv = make_sharded_env(env, env_spatial_mesh(spatial_shards=2))
    venv = PDEVectorEnv(senv, num_envs=8, seed=0)
    obs, _ = venv.reset()
    assert obs.shape[0] == 8
    for _ in range(2):
        acts = np.zeros((8, 1), np.float32)
        obs, rew, term, trunc, _ = venv.step(acts)
    assert obs.shape[0] == 8 and rew.shape == (8,)
