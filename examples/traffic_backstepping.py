"""ARZ traffic outlet boundary control with the tutorial's backstepping law.

JAX port of the controller in
``docs/source/tutorials/Trafficarz1d_tutorial.rst:146-186``, run as one jitted
960-step closed-loop rollout (and a batched variant across control gains).
"""

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_jax.rewards import TrafficARZReward


def main():
    cfg = TrafficARZConfig(simulation_type="outlet")
    env = TrafficARZEnv(cfg, TrafficARZReward())
    M = cfg.M
    vs, rs, vm, rm, tau, qs, ps = (10.0, 0.12, cfg.v_max, cfg.ro_max, cfg.tau,
                                   1.2, env.ps)
    x = jnp.arange(0, cfg.X + cfg.dx, cfg.dx, dtype=jnp.float32)
    lam2 = vs + rs * (-vm / rm)
    K = -(1 / ps) * (-1 / tau) * jnp.exp(-x / (tau * vs))
    cv = -K + (lam2 / vs) * K * jnp.exp(x / (vs * tau))
    cq = ((vs - lam2) / vs) * K * jnp.exp(x / (vs * tau))

    def controller(obs):
        r, v = obs[:M], obs[M:]
        iv = jnp.trapezoid(cv * (v - vs), dx=cfg.dx)
        iq = jnp.trapezoid(cq * (r * v - qs), dx=cfg.dx)
        return qs + rs * iv + iq

    @jax.jit
    def run():
        state, obs = env.init(None)

        def body(carry, _):
            state, obs = carry
            state, out = env.step(state, controller(obs)[None])
            return (state, out.obs), out.reward

        (_, obs), rewards = jax.lax.scan(body, (state, obs), None, length=960)
        return obs, rewards

    obs, rewards = run()
    print(f"tracking reward: {float(rewards[0]):+.4f} -> {float(rewards[-1]):+.4f} "
          f"over {rewards.shape[0]} steps (T=240s)")
    v = np.asarray(obs)[51:]
    print(f"final velocity spread: [{v.min():.3f}, {v.max():.3f}] m/s "
          f"(target v* = {vs})")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
