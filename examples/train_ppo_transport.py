"""Train PPO on the 1D transport boundary-control problem.

On-device replacement for ``examples/transportPDE/transport1Dppo.py``: the
reference trains SB3 PPO against one Python env for 1e6 steps; here 1024 envs
step in lockstep inside the jitted train loop. Checkpoints go through orbax
(``utils/checkpointing``) instead of SB3's CheckpointCallback.
"""

import argparse

import jax

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.tuned import TunedReward1D
from pdecontrolgym_jax.utils import save


def build_env():
    cfg = Boundary1DConfig(
        T=5.0, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
        limit_pde_state_size=True, max_state_value=1e10,
        max_control_value=20.0, normalize=True,
    )
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--num-steps", type=int, default=16)
    # the round-2 recipe hunt's winners (examples/eval_compare_transport.py):
    # gamma=0.99 + lr=1e-3 cross the terminal-bonus barrier
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reward-scale", type=float, default=1.0)
    ap.add_argument("--obs-clip", type=float, default=0.0)
    ap.add_argument("--anneal", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-dir", default=None,
                    help="write metrics.jsonl (+ TensorBoard scalars) here — "
                         "plot with utils.plotting.load_jsonl/reward_curves")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=0,
                    help=">0: evaluate mean episodic return over 32 episodes "
                         "every N iterations (logged as 'eval'; the runner "
                         "keeps the best-eval checkpoint)")
    args = ap.parse_args()

    env = build_env()
    trainer = PPOTrainer(
        env,
        PPOConfig(num_envs=args.num_envs, num_steps=args.num_steps,
                  num_epochs=4, num_minibatches=8, ent_coef=1e-3,
                  gamma=args.gamma, lr=args.lr,
                  reward_scale=args.reward_scale, obs_clip=args.obs_clip,
                  anneal_lr_iters=args.anneal),
    )

    logger = None
    if args.log_dir:
        from pdecontrolgym_jax.utils import MetricsLogger

        logger = MetricsLogger(args.log_dir)

    def log(it, m):
        extra = f"  eval {m['eval']:+.2f}" if "eval" in m else ""
        print(f"iter {it:5d}  mean_reward {m['mean_reward']:+.4f}  "
              f"loss {m['loss']:.4f}{extra}", flush=True)
        if logger is not None:
            logger.log(it, m)

    eval_fn = None
    if args.eval_every > 0:
        import jax.numpy as jnp

        from pdecontrolgym_jax.eval import episode_returns

        @jax.jit
        def eval_fn(params):
            policy = trainer.policy(params)
            rets, _ = episode_returns(
                env, lambda obs, _k: policy(obs), 32, jax.random.key(7),
                max_steps=int(round(env.config.T / env.config.control_sample_rate)),
            )
            return rets.mean()

    runner = trainer.train(jax.random.key(0), args.iterations,
                           log_every=args.log_every, callback=log,
                           eval_fn=eval_fn, eval_every=args.eval_every or 25)
    if logger is not None:
        logger.close()
    if args.checkpoint:
        save(args.checkpoint, runner)
        print(f"saved checkpoint to {args.checkpoint}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
