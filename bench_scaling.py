"""Scaling-efficiency harness: env-steps/s across device-mesh sizes.

BASELINE.md's multi-host bar is >=80% linear scaling at N>=2 hosts. This
harness measures weak-scaling efficiency of the lockstep rollout engine over a
1D env mesh: each mesh size k runs k x envs-per-device envs under
``shard_map`` (per-shard rollout + a ``psum`` over episode rewards, the same
collective shape as the PPO/SAC learners), so efficiency_k = rate_k / (k x
rate_1).

On a multi-GPU host it meshes over `jax.devices()` in one process; pass
``--multihost coordinator:port`` to initialize `jax.distributed` first (see
``parallel/mesh.multihost_env_mesh``). ``--virtual 8`` gives an 8-device
CPU mesh (correctness + efficiency shape; CPU rates are not device rates).
``--spawn-procs`` starts one process per device and runs on the CPU only: a
JAX process reserves most of a GPU's memory, so a card takes one process.

Prints ONE JSON line per mesh size:
    {"metric": "scaling", "mesh_size": k, "value": steps/s, "efficiency": e}
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs-per-device", type=int, default=512)
    ap.add_argument("--mesh-sizes", default="1,2,4,8")
    ap.add_argument("--agent-steps", type=int, default=10)
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (test mode)")
    ap.add_argument("--multihost", default=None,
                    help="coordinator address for jax.distributed")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--spawn-procs", type=int, default=0,
                    help="self-spawn N localhost processes (each with "
                         "--virtual devices) and mesh over ALL global "
                         "devices — the real multi-process jax.distributed "
                         "path, Gloo collectives on CPU")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    if args.spawn_procs > 1:
        # re-exec N-1 workers; this process becomes the coordinator
        import subprocess
        port = 29561 + (os.getpid() % 512)
        cmd = [sys.executable, os.path.abspath(__file__),
               "--envs-per-device", str(args.envs_per_device),
               "--agent-steps", str(args.agent_steps),
               "--repeats", str(args.repeats),
               "--virtual", str(args.virtual or 2),
               "--multihost", f"localhost:{port}",
               "--num-processes", str(args.spawn_procs)]
        workers = [subprocess.Popen(cmd + ["--process-id", str(i)],
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
                   for i in range(1, args.spawn_procs)]
        args.multihost = f"localhost:{port}"
        args.num_processes = args.spawn_procs
        args.process_id = 0
        args.virtual = args.virtual or 2
        try:
            _run(args)
        finally:
            # leave the distributed barrier before waiting on workers: their
            # exit-time shutdown blocks until the coordinator enters it too
            import jax
            jax.distributed.shutdown()
            for w in workers:
                w.wait(timeout=300)
        return
    _run(args)


def _run(args):

    if args.virtual:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )

    import numpy as np
    import jax

    from jax.sharding import Mesh, PartitionSpec as P

    if args.multihost:
        from pdecontrolgym_jax.parallel.mesh import multihost_env_mesh

        multihost_env_mesh(
            coordinator_address=args.multihost,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from bench import _build_transport
    from pdecontrolgym_jax.parallel.mesh import ENV_AXIS
    from pdecontrolgym_jax.parallel.rollout import rollout

    env, policy, _agent_steps, sample_rate = _build_transport(0)
    agent_steps = args.agent_steps
    devices = jax.devices()
    if args.multihost:
        # multi-process: one row, the GLOBAL mesh over every device
        sizes = [len(devices)]
    else:
        sizes = [int(s) for s in args.mesh_sizes.split(",")
                 if int(s) <= len(devices)]

    def shard_body(key):
        # per-shard independent rollout; reward psum = the learner's
        # collective shape (grad pmean in agents/ppo.py)
        key = jax.random.fold_in(key, jax.lax.axis_index(ENV_AXIS))
        _, outs = rollout(env, policy, args.envs_per_device, agent_steps, key)
        return jax.lax.psum(outs.reward.sum(), ENV_AXIS)

    results = []
    for k in sizes:
        mesh = Mesh(np.array(devices[:k]), (ENV_AXIS,))
        run = jax.jit(jax.shard_map(
            shard_body, mesh=mesh, in_specs=P(), out_specs=P(),
            check_vma=False,
        ))
        jax.block_until_ready(run(jax.random.key(0)))  # compile + warm
        best = float("inf")
        for i in range(args.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(jax.random.key(i + 1)))
            best = min(best, time.perf_counter() - t0)
        substeps = k * args.envs_per_device * agent_steps * sample_rate
        results.append((k, substeps / best))

    base = results[0][1] / results[0][0]
    for k, rate in results:
        print(json.dumps({
            "metric": f"transport env-steps/s @ mesh={k} "
                      f"({args.envs_per_device}/device)",
            "mesh_size": k,
            "value": round(rate),
            "unit": "env-steps/s",
            "efficiency": round(rate / (k * base), 3),
        }))
    eff = [rate / (k * base) for k, rate in results[1:]]
    if eff and min(eff) < 0.8:
        print(f"# WARNING: efficiency below the 80% bar: {min(eff):.1%}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
