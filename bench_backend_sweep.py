"""Kernel-vs-XLA sweep over state dimension, on the GPU (PERF.md).

For each env family and nx, measures sub-steps/s for ``backend='xla'``
(lax.scan) and ``backend='pallas'`` (the interval kernel, ops/pallas1d).
The results bound where ``backend='auto'`` picks the kernel
(``_kernel_wins`` in envs/transport.py, burgers.py, reaction_diffusion.py).

One JSON line per measurement:
    {"env": ..., "nx": N, "backend": ..., "value": sub-steps/s}
"""

import argparse
import json
import time


import jax
import jax.numpy as jnp


def _mk_transport(nx, backend):
    from pdecontrolgym_jax.envs.common import Boundary1DConfig
    from pdecontrolgym_jax.envs.transport import TransportEnv
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    cfg = Boundary1DConfig(
        T=5.0, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.1,
        backend=backend,
    )
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2))
    policy = lambda obs, _k: -0.5 * obs[..., -2]
    return env, policy, cfg.sample_rate


def _mk_burgers(nx, backend):
    from pdecontrolgym_jax.envs.burgers import BurgersConfig, BurgersEnv
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    cfg = BurgersConfig(
        T=1.0, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.01,
        viscosity=1e-3, backend=backend,
    )
    env = BurgersEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))
    policy = lambda obs, _k: -0.5 * obs[..., -2]
    return env, policy, cfg.sample_rate


def _mk_rd(nx, backend):
    from pdecontrolgym_jax.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    # explicit FTCS: dt pinned to 0.4x the Fourier stability bound, 100
    # sub-steps per control interval at every size
    dx = 1.0 / nx
    dt = 0.4 * dx * dx
    cfg = ReactionDiffusionConfig(
        T=10_000 * dt, dt=dt, X=1.0, dx=dx, control_sample_rate=100 * dt,
        scheme="explicit", backend=backend,
    )
    env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))
    policy = lambda obs, _k: -0.5 * obs[..., -2]
    return env, policy, cfg.sample_rate


def _rd_implicit_rows(num_envs, repeats, solvers):
    """Implicit-solver comparison at the bench.py RD config (nx=256, CN,
    dt=4e-4 = 40x the explicit bound, full 100-action episodes). Timing is
    amortized over 4 in-program episodes like bench.py; per-env β costs the
    same for thomas/pcr (elementwise over the batch), and dense requires the
    env-invariant default β either way."""
    from pdecontrolgym_jax.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_jax.parallel.rollout import rollout
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    for solver in solvers:
        # "<solver>-xla" pins backend="xla" (backend="auto" routes pcr
        # through the interval kernel on the GPU)
        name, _, forced = solver.partition("-")
        cfg = ReactionDiffusionConfig(
            T=1.0, dt=4e-4, X=1.0, dx=1.0 / 256, control_sample_rate=0.01,
            scheme="implicit", theta=0.5, implicit_solver=name,
            backend=forced or "auto",
        )
        env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))
        policy = lambda obs, _k: -0.1 * obs[..., -2]
        inner = 4

        def episode(key):
            return rollout(env, policy, num_envs, 100, key)[1].reward.sum()

        def run_fn(key):
            acc, _ = jax.lax.scan(
                lambda a, k: (a + episode(k).astype(jnp.float32), ()),
                jnp.zeros((), jnp.float32),
                jax.random.split(key, inner),
            )
            return acc

        run = jax.jit(run_fn)
        t0 = time.time()
        jax.block_until_ready(run(jax.random.key(0)))
        compile_s = time.time() - t0
        best = float("inf")
        for i in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run(jax.random.key(i + 1)))
            best = min(best, time.perf_counter() - t0)
        rate = num_envs * 100 * cfg.sample_rate * inner / best
        print(json.dumps({
            "env": "reaction_diffusion_implicit", "nx": 256,
            "solver": solver, "value": round(rate), "unit": "sub-steps/s",
            "compile_s": round(compile_s, 1),
        }), flush=True)


def _measure_backend(env, policy, num_envs, agent_steps, sample_rate, repeats):
    from pdecontrolgym_jax.parallel.rollout import rollout

    run = jax.jit(lambda key: rollout(
        env, policy, num_envs, agent_steps, key)[1].reward.sum())
    t0 = time.time()
    jax.block_until_ready(run(jax.random.key(0)))
    compile_s = time.time() - t0
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.key(i + 1)))
        best = min(best, time.perf_counter() - t0)
    return num_envs * agent_steps * sample_rate / best, compile_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--agent-steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rd-implicit", default=None,
                    help="comma list of implicit solvers to compare "
                         "(thomas,pcr,dense) instead of the backend sweep")
    # Burgers capped at 2048: the explicit viscous bound dt<=dx^2/(2nu)
    # fails at nx=4096 with the default dt/viscosity
    ap.add_argument("--transport-nx", default="128,256,512,1024,2048,4096")
    ap.add_argument("--burgers-nx", default="128,256,512,1024,2048")
    ap.add_argument("--rd-nx", default="128,256,512,1024,2048")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit("bench_backend_sweep.py measures the GPU kernel; "
                         "no GPU found")
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.rd_implicit:
        _rd_implicit_rows(args.envs, args.repeats,
                          [s for s in args.rd_implicit.split(",") if s])
        return

    jobs = []
    for nx in filter(None, args.transport_nx.split(",")):
        jobs.append(("transport", int(nx), _mk_transport))
    for nx in filter(None, args.burgers_nx.split(",")):
        jobs.append(("burgers", int(nx), _mk_burgers))
    for nx in filter(None, args.rd_nx.split(",")):
        jobs.append(("reaction_diffusion", int(nx), _mk_rd))

    for name, nx, mk in jobs:
        for backend in ("xla", "pallas"):
            env, policy, sample_rate = mk(nx, backend)
            rate, compile_s = _measure_backend(
                env, policy, args.envs, args.agent_steps, sample_rate,
                args.repeats)
            print(json.dumps({
                "env": name, "nx": nx, "backend": backend,
                "value": round(rate), "unit": "sub-steps/s",
                "compile_s": round(compile_s, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
