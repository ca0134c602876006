"""Multi-chip PPO: envs sharded over a device mesh, params replicated.

On a multi-GPU host this runs unchanged in one process — the mesh picks up
every local device; across hosts ``multihost_env_mesh(coordinator, n, i)``
initializes ``jax.distributed`` first. For a laptop/CI demonstration, force
a virtual 8-device CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/multichip_ppo.py --iterations 20
"""

import argparse

import jax

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.parallel.mesh import env_mesh
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--envs-per-device", type=int, default=64)
    args = ap.parse_args()

    mesh = env_mesh()
    n = mesh.size
    print(f"mesh: {n} device(s) — {jax.devices()[0].platform}")

    cfg = Boundary1DConfig(
        T=1.0, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.05,
        limit_pde_state_size=True, max_state_value=1e6, normalize=True,
    )
    env = TransportEnv(cfg, TunedReward1D(1000, -1e3, 3e2, lookback=50))
    trainer = PPOTrainer(
        env,
        PPOConfig(num_envs=args.envs_per_device * n, num_steps=20,
                  gamma=0.999, num_minibatches=4, reward_scale=0.02),
        mesh=mesh,
    )
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    for it in range(args.iterations):
        runner, m = step(runner)
        if it % 10 == 0 or it == args.iterations - 1:
            m = jax.device_get(m)
            print(f"iter {it:4d}  mean_reward {float(m['mean_reward']):+.3f}",
                  flush=True)
    p = jax.tree_util.tree_leaves(runner.params)[0]
    print(f"params replicated across mesh: {p.sharding.is_fully_replicated}")
    print(f"env states sharded: {not runner.obs.sharding.is_fully_replicated if n > 1 else 'n/a (1 device)'}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
