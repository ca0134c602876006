"""Multi-process distributed training demo: ``jax.distributed`` on localhost.

Executes the REAL multi-host code path end-to-end — NOT a virtual-device
simulation: N separate Python processes (coordinator + workers) each own a
disjoint set of devices, ``jax.distributed.initialize`` connects them, the
env batch shards over the GLOBAL mesh (``parallel/mesh.multihost_env_mesh``),
and the sharded PPO ``train_step`` (``agents/ppo.py``) runs with replicated
params and cross-process ``pmean`` gradients; on the CPU the collectives
ride Gloo. The demo spawns processes on the CPU only: a JAX process reserves
most of a GPU's memory, so one card takes one process (``chip_smoke.py
--four`` drives four cards from one process).

Each process prints a ``RESULT`` line with its loss / mean reward / parameter
checksum after the final iteration; identical values across processes prove
the initialize -> global mesh -> shard_map -> pmean chain synchronizes the
learners. A throughput line (agent env-steps/s through the train step) makes
this usable as the multi-process row of the scaling table (docs/STATUS.md).

Run (self-spawning, 2 processes x 2 devices):
    python examples/multihost_demo.py --spawn 2 --local-devices 2

Or manually, one command per host/process:
    python examples/multihost_demo.py --coordinator host0:29531 \
        --num-processes 2 --process-id {0,1}

The reference has no distributed anything (SURVEY.md section 2.3).
"""

import argparse
import os
import subprocess
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawn", type=int, default=0,
                    help="self-spawn N processes on localhost (this process "
                         "becomes the coordinator, process_id=0)")
    ap.add_argument("--coordinator", default="localhost:29531")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=2,
                    help="virtual CPU devices per process")
    ap.add_argument("--envs-per-device", type=int, default=64)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--algo", default="ppo", choices=("ppo", "sac"),
                    help="ppo: replicated params + pmean grads; sac: the "
                         "same PLUS a per-process replay-buffer shard — the "
                         "off-policy path's buffer writes/samples stay local "
                         "to each process while gradients cross")
    return ap.parse_args(argv)


def spawn(args):
    """Fork N-1 workers, run process 0 inline, merge + check RESULT lines."""
    cmd_base = [sys.executable, os.path.abspath(__file__),
                "--coordinator", args.coordinator,
                "--num-processes", str(args.spawn),
                "--local-devices", str(args.local_devices),
                "--envs-per-device", str(args.envs_per_device),
                "--iters", str(args.iters), "--nx", str(args.nx),
                "--algo", args.algo]
    workers = [
        subprocess.Popen(cmd_base + ["--process-id", str(i)],
                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                         text=True)
        for i in range(1, args.spawn)
    ]
    args.num_processes, args.process_id = args.spawn, 0
    result0 = run(args)
    # leave the distributed barrier BEFORE waiting on the workers: their
    # interpreter-exit shutdown blocks until every process (including this
    # coordinator) enters shutdown — waiting on them first deadlocks
    import jax

    jax.distributed.shutdown()
    results = [result0]
    for w in workers:
        out, _ = w.communicate(timeout=600)
        if w.returncode != 0:
            raise RuntimeError(f"worker exited {w.returncode}")
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        results.append(lines[-1])
        print(lines[-1], flush=True)
    checks = {r.split("checksum=")[1] for r in results}
    if len(checks) != 1:
        raise RuntimeError(f"param checksums diverged across processes: {checks}")
    print(f"OK: {args.spawn} processes agree (checksum {checks.pop()})",
          flush=True)


def run(args):
    # platform/devices must be pinned before the backend initializes
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.envs.common import Boundary1DConfig
    from pdecontrolgym_jax.envs.transport import TransportEnv
    from pdecontrolgym_jax.parallel.mesh import multihost_env_mesh
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    if args.num_processes > 1:
        mesh = multihost_env_mesh(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    else:
        mesh = multihost_env_mesh()
    n_dev = len(jax.devices())
    print(f"# process {args.process_id}/{args.num_processes}: "
          f"{len(jax.local_devices())} local / {n_dev} global devices",
          flush=True)

    cfg = Boundary1DConfig(T=1.0, dt=1e-3, X=1.0, dx=1.0 / args.nx,
                           control_sample_rate=1e-2)
    env = TransportEnv(cfg, TunedReward1D(cfg.nt - 1))
    num_envs = args.envs_per_device * n_dev
    if args.algo == "sac":
        from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer

        trainer = SACTrainer(
            env,
            SACConfig(num_envs=num_envs, steps_per_iter=8,
                      updates_per_iter=2, batch_size=64,
                      buffer_size=256 * n_dev, hidden=(32, 32)),
            mesh=mesh,
        )
        loss_key, steps_per_iter = "critic_loss", 8
        params_of = lambda r: (r.actor_params, r.critic_params)
    else:
        trainer = PPOTrainer(
            env,
            PPOConfig(num_envs=num_envs, num_steps=8, num_epochs=2,
                      num_minibatches=2, hidden=(32, 32)),
            mesh=mesh,
        )
        loss_key, steps_per_iter = "loss", 8
        params_of = lambda r: r.params
    runner = trainer.init(jax.random.key(0))
    train_step = trainer.make_train_step()
    runner, metrics = train_step(runner)  # compile + warm

    t0 = time.perf_counter()
    for _ in range(args.iters):
        runner, metrics = train_step(runner)
    # scalar readbacks double as the cross-process barrier
    loss = float(np.asarray(metrics[loss_key].addressable_data(0)))
    rew = float(np.asarray(metrics["mean_reward"].addressable_data(0)))
    dt_s = time.perf_counter() - t0

    leaves = jax.tree_util.tree_leaves(params_of(runner))
    checksum = float(sum(
        np.abs(np.asarray(l.addressable_data(0))).sum() for l in leaves
    ))
    rate = args.iters * num_envs * steps_per_iter / dt_s  # agent env-steps/s
    line = (f"RESULT algo={args.algo} proc={args.process_id} devices={n_dev} "
            f"envs={num_envs} agent_env_steps_per_s={rate:.0f} "
            f"loss={loss:.6f} mean_reward={rew:.6f} checksum={checksum:.6f}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    a = parse_args()
    if a.spawn > 1:
        spawn(a)
    else:
        run(a)
