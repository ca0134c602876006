"""Closed-loop backstepping control of the 1D transport PDE.

JAX port of ``examples/transportPDE/transport1Dbackstepping.py``: the
same episode (T=5, dt=1e-4, dx=1e-2, control every 0.1s) driven through the
Gymnasium adapter, plus the same rollout executed as a single jitted lax.scan
over a batch of envs — the intended high-throughput path.
"""

import numpy as np

import jax
import jax.numpy as jnp

import gymnasium as gym

import pdecontrolgym_jax  # noqa: F401  (registers PDEControlGym-* ids)
from pdecontrolgym_jax.agents.backstepping import transport_control, transport_kernel
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards import TunedReward1D

T, dt, dx, X = 5.0, 1e-4, 1e-2, 1.0
nx = int(round(X / dx))


def beta_fn(nx):
    x = np.linspace(0, 1, nx)
    return (5 * np.cos(7.35 * np.arccos(x))).astype(np.float32)


def main():
    rng = np.random.default_rng(7)
    u0 = np.ones(nx, np.float32) * rng.uniform(1, 10)

    # --- Gymnasium adapter path (reference API) ---------------------------
    env = gym.make(
        "PDEControlGym-TransportPDE1D",
        T=T, dt=dt, X=X, dx=dx,
        reward_class=TunedReward1D(int(round(T / dt)), -1e3, 3e2),
        normalize=False,
        sensing_loc="full", control_type="Dirchilet", sensing_type=None,
        sensing_noise_func=lambda s: s,
        limit_pde_state_size=True, max_state_value=1e10, max_control_value=20,
        reset_init_condition_func=lambda n: u0,
        reset_recirculation_func=beta_fn,
        control_sample_rate=0.1,
    )
    spatial = np.linspace(dx, X, nx)
    kernel = transport_kernel(
        jnp.asarray(5 * np.cos(7.35 * np.arccos(spatial)), jnp.float32), dx
    )
    obs, _ = env.reset()
    total, steps, term, trunc = 0.0, 0, False, False
    while not (term or trunc):
        action = float(transport_control(kernel, jnp.asarray(obs), dx))
        obs, rew, term, trunc, _ = env.step(np.float32(action))
        total += rew
        steps += 1
    print(f"[gym adapter]   steps={steps}  total_reward={total:.2f}  "
          f"final_l2={np.linalg.norm(obs):.4f}")

    # --- batched functional path (jit + vmap + scan) ----------------------
    cfg = Boundary1DConfig(T=T, dt=dt, X=X, dx=dx, limit_pde_state_size=True,
                           control_sample_rate=0.1)
    fenv = TransportEnv(cfg, TunedReward1D(int(round(T / dt)), -1e3, 3e2))
    B = 256
    keys = jax.random.split(jax.random.key(0), B)
    state, obs_b = jax.vmap(fenv.init)(keys)

    @jax.jit
    def rollout(state, obs):
        def body(carry, _):
            state, obs = carry
            actions = jax.vmap(lambda o: transport_control(kernel, o, dx))(obs)
            state, out = jax.vmap(fenv.step)(state, actions)
            return (state, out.obs), out.reward

        (state, obs), rewards = jax.lax.scan(body, (state, obs), None, length=50)
        return state, obs, rewards.sum(axis=0)

    state, obs_b, returns = rollout(state, obs_b)
    print(f"[batched x{B}]  mean_return={float(returns.mean()):.2f}  "
          f"min={float(returns.min()):.2f}  max={float(returns.max()):.2f}  "
          f"mean_final_l2={float(jnp.linalg.norm(obs_b, axis=1).mean()):.4f}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
