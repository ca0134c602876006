"""Glioblastoma therapy schedules: open-loop vs the paper's 1.8 Gy/day.

JAX port of the BrainTumor1DExample notebook flow: benchmark the
untreated baseline survival, then run treatment schedules through the
functional TherapyEnv (Growth fast-forwarded at init, Post-Therapy inside one
step) and report survival extension (the episodic reward).
"""

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    TherapyEnv,
)
from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward


def main():
    cfg = BrainTumorConfig(total_dosage=61.2)
    env = BrainTumorEnv(cfg, BrainTumorReward())
    ther = TherapyEnv(env)

    t_benchmark = int(jax.jit(ther.benchmark)(jax.random.key(0)))
    print(f"untreated baseline survival: {t_benchmark} days")

    @jax.jit
    def run_schedule(dose_fraction):
        state, obs = ther.init(jax.random.key(0), t_benchmark=t_benchmark)

        def body(carry, _):
            state, total, done = carry
            stepped, out = ther.step(state, dose_fraction)
            fin = jnp.logical_or(out.terminated, out.truncated)
            total = total + jnp.where(done, 0.0, out.reward)
            # freeze at the first episode end (truncation doesn't stop the
            # PDE by itself, matching the reference env)
            state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(done, a, b), state, stepped
            )
            return (state, total, jnp.logical_or(done, fin)), None

        (state, total, _), _ = jax.lax.scan(
            body, (state, jnp.zeros(()), jnp.zeros((), bool)), None,
            length=cfg.nt,
        )
        return state.simulation_days, total

    for label, frac in [("open loop (no dose)", 0.0),
                        ("paper 1.8 Gy/day", 1.8 / 61.2),
                        ("aggressive 3.0 Gy/day", 3.0 / 61.2)]:
        days, total = run_schedule(jnp.float32(frac))
        print(f"{label:24s}: survival {int(days):4d} days "
              f"({int(days) - t_benchmark:+d} vs baseline), total reward {float(total):8.2f}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
