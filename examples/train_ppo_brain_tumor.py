"""Train PPO on the glioblastoma therapy-scheduling problem.

The counterpart of the BrainTumor1DExample notebook's RL section (SB3 PPO over
TherapyWrapper, 1e6 steps, converged ~3e5 per
``docs/source/environments/braintumor-1d.rst:183-187``). The agent sees the
tumor density profile each treatment day and chooses the dose fraction; reward
is survival extension minus clinical toxicity. The staged episode structure
(growth fast-forward at reset, post-therapy fast-forward at episode end) runs
inside the jitted TherapyEnv.
"""

import argparse

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    DoseTherapyEnv,
    TherapyEnv,
)
from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--save-params", default=None,
                    help="directory for brain_tumor_ppo.msgpack")
    args = ap.parse_args()

    cfg = BrainTumorConfig(total_dosage=61.2)
    base = BrainTumorEnv(cfg, BrainTumorReward())
    tb = int(jax.jit(TherapyEnv(base).benchmark)(jax.random.key(0)))
    print(f"baseline survival (t_benchmark): {tb} days")
    env = DoseTherapyEnv(base, t_benchmark=tb)

    trainer = PPOTrainer(
        env,
        PPOConfig(num_envs=64, num_steps=40, num_epochs=4, num_minibatches=4,
                  gamma=0.999, reward_scale=0.05, ent_coef=1e-3),
    )

    # eval-based checkpoint selection (the schedule's return = survival
    # extension minus toxicity, the notebook table's metric up to the
    # toxicity term) — the policy peaks and then over-trains like RD PPO
    from pdecontrolgym_jax.eval import compare_controllers

    def eval_fn(params):
        r = compare_controllers(env, {"c": trainer.policy(params)},
                                num_episodes=16, max_steps=128,
                                key=jax.random.key(7))
        return r["c"]["mean_return"]

    runner = trainer.train(
        jax.random.key(args.seed), args.iterations,
        eval_fn=eval_fn, eval_every=args.eval_every,
        callback=lambda it, m: print(
            f"iter {it:4d}  mean_step_reward {m['mean_reward']:+.4f}"
            + (f"  eval {m['eval']:+.1f} (best {m['best_eval']:+.1f})"
               if "eval" in m else ""), flush=True),
    )

    # evaluate the learned schedule on one episode
    policy = trainer.policy(runner.params)
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
          f"({int(state.simulation_days) - tb:+d} vs baseline), return {total:.1f}")
    if args.save_params:
        from pdecontrolgym_jax.utils import save_params

        save_params(f"{args.save_params}/brain_tumor_ppo.msgpack", runner.params)


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
