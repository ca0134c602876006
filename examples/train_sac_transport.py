"""Train SAC on the 1D transport boundary-control problem.

On-device replacement for ``examples/transportPDE/transport1Dsac.py`` (SB3
SAC, single env): device-resident replay buffer, 64 lockstep envs, twin-Q +
learnable temperature, all inside one jitted train step.
"""

import argparse

import jax

from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.rewards.tuned import TunedReward1D
from pdecontrolgym_jax.utils import save


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args()

    cfg = Boundary1DConfig(
        T=5.0, dt=1e-4, X=1.0, dx=1e-2, control_sample_rate=0.1,
        limit_pde_state_size=True, max_state_value=1e10,
        max_control_value=20.0, normalize=True,
    )
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2))
    trainer = SACTrainer(env, SACConfig(num_envs=64, buffer_size=400_000,
                                        batch_size=512, steps_per_iter=2,
                                        updates_per_iter=32, gamma=0.999,
                                        init_alpha=0.05))
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    for it in range(args.iterations):
        runner, m = step(runner)
        if it % 20 == 0 or it == args.iterations - 1:
            m = jax.device_get(m)
            print(f"iter {it:4d}  mean_reward {m['mean_reward']:+.4f}  "
                  f"critic {m['critic_loss']:.3f}  alpha {m['alpha']:.3f}",
                  flush=True)
    if args.checkpoint:
        save(args.checkpoint, runner)


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
