"""Train SAC on the glioblastoma therapy-scheduling problem.

The SAC half of the brain-tumor RL pair (PPO: ``train_ppo_brain_tumor.py``;
the reference trains SB3 over TherapyWrapper — the
BrainTumor1DExample notebook's RL section). Same task surface: the agent sees
the normalized tumor density each treatment day, picks a dose fraction, and
is rewarded with survival extension minus clinical toxicity
(``rewards/brain_tumor.py``); the staged episode (growth fast-forward at
reset, post-therapy fast-forward at the end) runs inside the jitted
TherapyEnv.
"""

import argparse

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_jax.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    DoseTherapyEnv,
    TherapyEnv,
)
from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--save-params", default=None,
                    help="directory for brain_tumor_sac.msgpack")
    args = ap.parse_args()

    cfg = BrainTumorConfig(total_dosage=61.2)
    base = BrainTumorEnv(cfg, BrainTumorReward())
    tb = int(jax.jit(TherapyEnv(base).benchmark)(jax.random.key(0)))
    print(f"baseline survival (t_benchmark): {tb} days")
    env = DoseTherapyEnv(base, t_benchmark=tb)

    sac = SACTrainer(env, SACConfig(
        num_envs=64, buffer_size=100_000, batch_size=256,
        steps_per_iter=8, updates_per_iter=16,
        gamma=0.999, lr=1e-3, init_alpha=0.1, reward_scale=0.05,
    ))

    from pdecontrolgym_jax.eval import compare_controllers

    def eval_fn(params):
        r = compare_controllers(env, {"c": sac.policy(params)},
                                num_episodes=16, max_steps=128,
                                key=jax.random.key(7))
        return r["c"]["mean_return"]

    runner = sac.train(
        jax.random.key(args.seed), args.iterations,
        eval_fn=eval_fn, eval_every=args.eval_every,
        callback=lambda it, m: print(
            f"iter {it:4d}  mean_step_reward {m['mean_reward']:+.4f}"
            + (f"  eval {m['eval']:+.1f} (best {m['best_eval']:+.1f})"
               if "eval" in m else ""), flush=True),
    )

    policy = sac.policy(runner.actor_params)
    state, obs = env.init(jax.random.key(42))
    done, total = False, 0.0
    stepf = jax.jit(env.step)
    while not done:
        a = policy(obs[None])[0]
        state, out = stepf(state, a)
        obs = out.obs
        total += float(out.reward)
        done = bool(out.terminated) or bool(out.truncated)
    print(f"learned schedule: survival {int(state.simulation_days)} days "
          f"({int(state.simulation_days) - tb:+d} vs baseline), "
          f"return {total:.1f}")
    if args.save_params:
        from pdecontrolgym_jax.utils import save_params

        save_params(f"{args.save_params}/brain_tumor_sac.msgpack",
                    runner.actor_params)
        print(f"saved {args.save_params}/brain_tumor_sac.msgpack")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
