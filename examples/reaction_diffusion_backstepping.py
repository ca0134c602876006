"""Closed-loop Goursat-kernel backstepping on the 1D reaction-diffusion PDE.

JAX port of
``examples/reactionDiffusionPDE/reactionDiffusion1DBackstepping.py`` — the
same episode (T=1, dt=1e-5, dx=5e-3, control every 1ms) plus a batched
variant, and the implicit Crank-Nicolson mode (an extension beyond the reference) at 50x the explicit
stability limit.
"""

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.backstepping import parabolic_control, parabolic_kernel
from pdecontrolgym_jax.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_jax.rewards import TunedReward1D

T, dt, dx, X = 1.0, 1e-5, 5e-3, 1.0
nx = int(round(X / dx))


def main():
    rng = np.random.default_rng(1)
    height = rng.uniform(1, 10)
    u0 = np.full(nx + 1, height, np.float32)
    beta = (50 * np.cos(8 * np.arccos(np.linspace(0, 1, nx + 1)))).astype(np.float32)

    spatial = np.linspace(dx, X, nx + 1)
    krow = parabolic_kernel(
        jnp.asarray(50 * np.cos(8 * np.arccos(spatial)), jnp.float32), dx
    )

    for scheme, step_dt, rate in [("explicit", dt, 1e-3), ("implicit", 5e-4, 1e-2)]:
        cfg = ReactionDiffusionConfig(
            T=T, dt=step_dt, X=X, dx=dx, control_sample_rate=rate,
            limit_pde_state_size=True, scheme=scheme, theta=0.5,
        )
        env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(T / step_dt)), -1e3, 3e2))
        step = jax.jit(env.step)
        state, obs = env.init_from(u0, beta)
        total, done = 0.0, False
        while not done:
            a = parabolic_control(krow, obs, dx)
            state, out = step(state, a)
            obs = out.obs
            total += float(out.reward)
            done = bool(out.terminated) or bool(out.truncated)
        print(f"[{scheme:8s} dt={step_dt:.0e}] total_reward={total:8.2f}  "
              f"final_l2={np.linalg.norm(np.asarray(obs)):.4f}  (u0 height {height:.2f})")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
