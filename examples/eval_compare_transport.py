"""Compare controllers on 1D transport: backstepping vs PPO vs random.

Batched JAX port of ``examples/transportPDE/transport1DtestAlgorithm.py``: N evaluation
episodes run as one vmapped batch per controller. Trains a quick PPO policy
in-process (pass --ppo-iters 0 to skip).
"""

import argparse

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.backstepping import transport_control, transport_kernel
from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.eval import compare_controllers
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--ppo-iters", type=int, default=150)
    ap.add_argument("--sac-iters", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0,
                    help=">0: eval-selected checkpoints (PPOTrainer.train "
                         "eval_fn) every N iters")
    ap.add_argument("--eval-episodes", type=int, default=50)
    ap.add_argument("--anneal", type=int, default=0,
                    help=">0: linearly anneal PPO lr to 0 over this many iters")
    # recipe hunt (round 2): gamma=0.99 + lr=1e-3 crosses the terminal-bonus
    # cliff by ~iter 120 and reaches backstepping-level returns; the old
    # defaults (gamma=0.999, lr=3e-4) plateau near +15 without the bonus
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--lr", type=float, default=1e-3)
    # same sweep for SAC: gamma=0.99 + lr=1e-3 reaches ~213 by iter 800
    # (old gamma=0.999 recipe plateaus at +2; reward_scale=0.02 kills it)
    ap.add_argument("--sac-gamma", type=float, default=0.99)
    ap.add_argument("--sac-lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-params", default=None,
                    help="directory for transport_ppo.msgpack / _sac.msgpack")
    args = ap.parse_args()

    import dataclasses

    # Like the reference testAlgorithm (transport1DtestAlgorithm.py:78-152):
    # backstepping runs on a normalize=False env, RL policies on
    # normalize=True envs ([-1,1] actions mapped onto [-20,20]).
    cfg = Boundary1DConfig(
        T=5.0, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
        limit_pde_state_size=True, max_state_value=1e10,
        max_control_value=20.0,
    )
    nx = cfg.nx
    reward = TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2)
    env = TransportEnv(cfg, reward)
    env_rl = TransportEnv(dataclasses.replace(cfg, normalize=True), reward)

    spatial = jnp.linspace(cfg.dx, cfg.X, nx)
    kern = transport_kernel(
        (5 * jnp.cos(7.35 * jnp.arccos(jnp.clip(spatial, -1, 1)))).astype(jnp.float32),
        cfg.dx,
    )
    controllers = {
        "backstepping": lambda o, k: jax.vmap(
            lambda ob: transport_control(kern, ob, cfg.dx)
        )(o),
        "zero": lambda o, k: jnp.zeros(o.shape[0]),
    }

    results = compare_controllers(env, controllers, num_episodes=args.episodes,
                                  max_steps=50)

    def eval_fn_for(policy_of_params):
        def eval_fn(params):
            r = compare_controllers(
                env_rl, {"c": policy_of_params(params)},
                num_episodes=args.eval_episodes, max_steps=50,
                key=jax.random.key(7),
            )
            return r["c"]["mean_return"]

        return eval_fn

    log = lambda tag: (lambda it, m: print(
        f"  {tag} iter {it}: mean {m['mean_reward']:+.3f}"
        + (f"  eval {m['eval']:+.2f} (best {m['best_eval']:+.2f})"
           if "eval" in m else ""), flush=True))

    if args.ppo_iters > 0:
        trainer = PPOTrainer(env_rl, PPOConfig(num_envs=512, num_steps=50,
                                               gamma=args.gamma, lr=args.lr,
                                               num_minibatches=8, ent_coef=1e-3,
                                               reward_scale=0.02, obs_clip=50.0,
                                               anneal_lr_iters=args.anneal))
        runner = trainer.train(
            jax.random.key(args.seed), args.ppo_iters, log_every=50,
            eval_fn=eval_fn_for(trainer.policy) if args.eval_every else None,
            eval_every=args.eval_every or 25, callback=log("ppo"))
        results.update(compare_controllers(
            env_rl, {"ppo": trainer.policy(runner.params)},
            num_episodes=args.episodes, max_steps=50,
        ))
        if args.save_params:
            from pdecontrolgym_jax.utils import save_params

            save_params(f"{args.save_params}/transport_ppo.msgpack",
                        runner.params)

    if args.sac_iters > 0:
        from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer

        # off-policy: the update count matters more than env steps
        # (2500 iters x 32 updates ~ 80K updates -> mean return ~230)
        sac = SACTrainer(env_rl, SACConfig(num_envs=64, buffer_size=400_000,
                                           batch_size=512, steps_per_iter=2,
                                           updates_per_iter=32,
                                           gamma=args.sac_gamma,
                                           lr=args.sac_lr,
                                           init_alpha=0.05))
        srunner = sac.train(
            jax.random.key(args.seed + 1), args.sac_iters, log_every=100,
            eval_fn=eval_fn_for(sac.policy) if args.eval_every else None,
            eval_every=args.eval_every or 100, callback=log("sac"))
        results.update(compare_controllers(
            env_rl, {"sac": sac.policy(srunner.actor_params)},
            num_episodes=args.episodes, max_steps=50,
        ))
        if args.save_params:
            from pdecontrolgym_jax.utils import save_params

            save_params(f"{args.save_params}/transport_sac.msgpack",
                        srunner.actor_params)
    print(f"\n{'controller':>14} | {'mean return':>12} | {'std':>8}")
    for name, r in sorted(results.items(), key=lambda kv: -kv[1]["mean_return"]):
        print(f"{name:>14} | {r['mean_return']:12.2f} | {r['std_return']:8.2f}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
