"""Smoke run of the engine on NVIDIA GPUs, through the public entry points.

    python chip_smoke.py          # one card: phases (a)-(d) below
    python chip_smoke.py --four   # four cards: data-parallel PPO/SAC and a
                                  # spatially sharded rollout vs one card

One card, one process:

(a) compile each interval kernel (ops/pallas1d) at its bench width and print
    ``compiled.memory_analysis()``;
(b) open-loop rollouts at the bench sizes (``rollout``/``step_batch``),
    each checked against the plain reference, ``backend="xla"`` on the card
    in float32, and against a float64 XLA run at a reduced env count;
(c) a few PPO and SAC train steps on transport at ``bench_train.py``'s
    sizes and one PPO step on Navier-Stokes, with finite losses;
(d) times (``block_until_ready``) and rates for (b) and (c).

Any failed check exits non-zero. The last line of stdout is the JSON
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. Without a GPU the script exits 1 before doing any work.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Tolerances. Kernel vs XLA after ONE control interval: both run the same
# scheme in f32 and differ only in fused multiply-add contraction and
# summation order, a few ulps per sub-step.
STATE_RTOL = 1e-5
# Kernel vs XLA episode return. The kernel sums a constant boundary as
# |ctrl| x sub-steps where XLA adds it 1000 times in f32 (bsum, which the
# tuned reward reads), so the two returns differ by f32 accumulation error
# of ~1e-4 relative (H100 measurement in PERF.md).
RETURN_RTOL = 1e-3
# f32 vs f64 XLA over a whole episode from the same initial state, relative
# episode return: f32 rounding accumulated over up to 50,000 sub-steps. The
# Crank-Nicolson PCR body (Fourier number dt/dx^2 = 26) loses the most, in
# the kernel and in XLA alike: 8.5e-4 measured on an H100 for the kernel;
# every other cell stays below 5e-6 (PERF.md).
DRIFT_RTOL = 2e-3
DRIFT_ENVS = 256
# (env, algo, envs) of phase (c), bench_train.py's sizes; envs of --four
TRAIN_CELLS = (("transport", "ppo", 4096), ("transport", "sac", 4096),
               ("ns", "ppo", 2048))
FOUR_ENVS = 4096


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def timed(fn, *args, repeats=3):
    """(first call incl. compile, best of ``repeats``) seconds, outputs."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# -- cells ---------------------------------------------------------------------


def cells():
    """name -> (build, envs). ``build(**config_overrides)`` returns
    ``(env, policy, agent steps per episode, PDE sub-steps per agent
    step)``; overriding ``dtype`` (and ``backend`` for the 1D families)
    builds the references. The 1D cells run the interval kernel under
    ``backend="auto"``; the others run XLA."""
    import functools

    import bench
    import bench_families as bf

    def one_sub(cell):
        return lambda **ov: cell(**ov) + (1,)

    def rd_explicit(**ov):
        # the reference's own RD example: FTCS, dt=1e-5, dx=5e-3, 10
        # sub-steps per action (cut to 100 of its 1000 actions)
        from pdecontrolgym_jax.envs.reaction_diffusion import (
            ReactionDiffusionConfig, ReactionDiffusionEnv)
        from pdecontrolgym_jax.rewards.tuned import TunedReward1D

        cfg = ReactionDiffusionConfig(T=0.1, dt=1e-5, X=1.0, dx=5e-3,
                                      control_sample_rate=1e-4, **ov)
        env = ReactionDiffusionEnv(cfg, TunedReward1D(cfg.nt - 1))
        return env, (lambda obs, _k: -0.1 * obs[..., -2]), 100, cfg.sample_rate

    def drop_n(build):
        return lambda **ov: build(**ov)[:4]

    return {
        "transport": (drop_n(functools.partial(bench._build_transport, 4096)), 4096),
        "burgers": (drop_n(functools.partial(bench._build_burgers, 4096)), 4096),
        "rd_implicit": (drop_n(functools.partial(
            bench._build_reaction_diffusion, 4096)), 4096),
        "rd_explicit": (rd_explicit, 4096),
        "ns64_direct": (drop_n(functools.partial(bench._build_ns, 2048)), 2048),
        "traffic": (one_sub(bf.traffic_cell), 4096),
        "neuron": (one_sub(bf.neuron_cell), 4096),
        "brain_tumor": (one_sub(bf.brain_tumor_cell), 4096),
    }


KERNEL_CELLS = ("transport", "burgers", "rd_implicit", "rd_explicit")


def episode_by_steps(env, policy, steps, state, obs):
    """One episode of batched steps (no autoreset) from a given batch
    state; returns (final state, summed reward per env)."""
    import jax
    import jax.numpy as jnp

    from pdecontrolgym_jax.parallel.rollout import batch_step

    step = batch_step(env, autoreset=False)

    def body(carry, _):
        s, o, ret = carry
        s, out = step(s, policy(o, None), None)
        return (s, out.obs, ret + out.reward.astype(ret.dtype)), None

    ret0 = jnp.zeros(obs.shape[0], obs.dtype)
    (s, _, ret), _ = jax.lax.scan(body, (state, obs, ret0), None, length=steps)
    return s, ret


def to_dtype(tree, dtype):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def phase_a(cs):
    import jax
    import jax.numpy as jnp

    for name in KERNEL_CELLS:
        build, n = cs[name]
        env = build()[0]
        check(env._uses_kernel(), f"(a) {name}: auto did not pick the kernel")
        D, dt = env.state_dim, env.config.dtype
        shapes = (jax.ShapeDtypeStruct((n, D), dt),
                  jax.ShapeDtypeStruct((n, D), dt),
                  jax.ShapeDtypeStruct((n, 1), dt),
                  jax.ShapeDtypeStruct((n, 1), jnp.int32))
        t0 = time.perf_counter()
        compiled = env._get_interval_fn().lower(*shapes).compile()
        print(f"(a) {name}: interval kernel compiled for {n}x{D} in "
              f"{time.perf_counter() - t0:.2f} s; memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)


def phase_b(cs):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdecontrolgym_jax.parallel.rollout import batch_init, rollout

    rows = []
    for name, (build, n) in cs.items():
        env, policy, steps, sub = build()
        kernel = name in KERNEL_CELLS
        run = jax.jit(lambda k, env=env, policy=policy, steps=steps, n=n:
                      rollout(env, policy, n, steps, k))
        first, best, ((state, _), outs) = timed(run, jax.random.key(0))
        check(bool(np.isfinite(np.asarray(outs.reward)).all()),
              f"(b) {name}: non-finite reward")
        line = (f"(b) {name}: {n} envs x {steps} steps x {sub} sub-steps: "
                f"compile+first {first:.3f} s, best {best * 1e3:.3f} ms, "
                f"{n * steps * sub / best:.6g} PDE sub-steps/s "
                f"[{'kernel' if kernel else 'xla'}]")
        if kernel:
            xenv = build(backend="xla")[0]
            xrun = jax.jit(lambda k: rollout(xenv, policy, n, steps, k))
            _, xbest, (_, xouts) = timed(xrun, jax.random.key(0))
            # one interval from the same state
            s0, o0 = batch_init(env, n)(jax.random.key(1))
            a0 = policy(o0, None)
            sk, _ = jax.jit(env.step_batch)(s0, a0)
            sx, _ = jax.jit(xenv.step_batch)(s0, a0)
            d_int = rel(sk.u, sx.u)
            d_ret = rel(np.asarray(outs.reward).sum(0),
                        np.asarray(xouts.reward).sum(0))
            line += (f"; xla best {xbest * 1e3:.3f} ms "
                     f"({n * steps * sub / xbest:.6g}/s), kernel speedup "
                     f"{xbest / best:.3f}x; one-interval state rel diff "
                     f"{d_int:.3e} (tol {STATE_RTOL}), episode return rel "
                     f"diff {d_ret:.3e} (tol {RETURN_RTOL})")
            print(line, flush=True)
            check(d_int <= STATE_RTOL,
                  f"(b) {name}: one interval, kernel vs xla {d_int:.3e}")
            check(d_ret <= RETURN_RTOL,
                  f"(b) {name}: episode return, kernel vs xla {d_ret:.3e}")
            rows.append((name, best, xbest))
        else:
            print(line, flush=True)
        # float64 XLA at a reduced env count, from the same initial state
        m = min(n, DRIFT_ENVS)
        s0, o0 = batch_init(env, m)(jax.random.key(2))
        s32, r32 = jax.jit(lambda s, o: episode_by_steps(
            env, policy, steps, s, o))(s0, o0)
        over = {"dtype": jnp.float64}
        if kernel:
            over["backend"] = "xla"
        with jax.enable_x64(True):
            env64, pol64 = build(**over)[:2]
            s64, r64 = jax.jit(lambda s, o: episode_by_steps(
                env64, pol64, steps, s, o))(to_dtype(s0, jnp.float64),
                                            o0.astype(jnp.float64))
            r64 = np.asarray(r64)
            s64 = jax.tree_util.tree_map(np.asarray, s64)
        d_ret64 = rel(r32, r64)
        u0 = np.asarray(jax.tree_util.tree_leaves(s0)[0], np.float64)
        u32 = np.asarray(jax.tree_util.tree_leaves(s32)[0], np.float64)
        u64 = np.asarray(jax.tree_util.tree_leaves(s64)[0], np.float64)
        d_u64 = float(np.max(np.abs(u32 - u64)) / max(np.max(np.abs(u0)), 1e-30))
        line = (f"(b) {name}: f32 {'kernel' if kernel else 'xla'} vs f64 xla "
                f"over one episode ({m} envs): return rel diff {d_ret64:.3e} "
                f"(tol {DRIFT_RTOL}), final state diff / initial max "
                f"{d_u64:.3e}")
        if kernel:
            # the plain f32 reference's own drift, for comparison
            _, rx32 = jax.jit(lambda s, o: episode_by_steps(
                xenv, policy, steps, s, o))(s0, o0)
            line += f"; f32 xla vs f64 xla: return rel diff {rel(rx32, r64):.3e}"
        print(line, flush=True)
        check(np.isfinite(d_ret64) and d_ret64 <= DRIFT_RTOL,
              f"(b) {name}: f32 vs f64 episode return {d_ret64:.3e}")
    return rows


def phase_c():
    import jax
    import numpy as np

    import bench_train

    out = []
    for env_name, algo, n in TRAIN_CELLS:
        trainer, step_fn, metric, sub = bench_train.build(
            env_name, algo, envs=n, num_steps=16)
        runner = trainer.init(jax.random.key(0))
        step = jax.jit(step_fn)
        first, best, (runner, metrics) = timed(step, runner, repeats=2)
        loss = float(np.asarray(metrics[metric]))
        check(np.isfinite(loss), f"(c) {algo} {env_name}: loss {loss}")
        rate = n * 16 / best
        print(f"(c) {algo} {env_name}: {n} envs x 16 steps per train step: "
              f"compile+first {first:.3f} s, best {best * 1e3:.3f} ms, "
              f"{rate:.6g} agent env-steps/s ({rate * sub:.6g} PDE "
              f"sub-steps/s), {metric} {loss:.6g}", flush=True)
        out.append((algo, env_name, best))
    return out


def one_card():
    cs = cells()
    phase_a(cs)
    rows = phase_b(cs)
    phase_c()
    for name, best, xbest in rows:
        print(f"(d) {name}: kernel {best * 1e3:.3f} ms vs xla "
              f"{xbest * 1e3:.3f} ms per episode", flush=True)


def four_cards():
    """Data-parallel PPO/SAC over a 4-card env mesh vs the same global
    batch on one card, and a spatially sharded transport rollout vs the
    unsharded one."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
    from pdecontrolgym_jax.envs.common import Boundary1DConfig
    from pdecontrolgym_jax.envs.transport import TransportEnv
    from pdecontrolgym_jax.parallel.mesh import env_mesh
    from pdecontrolgym_jax.parallel.rollout import rollout
    from pdecontrolgym_jax.parallel.spatial import env_spatial_mesh, make_sharded_env
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    cfg = Boundary1DConfig(T=5.0, dt=1e-4, X=1.0, dx=1.0 / 128,
                           control_sample_rate=0.1,
                           limit_pde_state_size=True, max_state_value=1e10)
    env = TransportEnv(cfg, TunedReward1D(cfg.nt - 1, -1e3, 3e2))
    iters = 3

    def run(runner, step):
        for _ in range(iters):
            runner, metrics = step(runner)
        jax.block_until_ready(runner)
        return runner, metrics

    # PPO with a deterministic policy (log_std pinned far below zero, so an
    # action equals the mean to f32 precision) and one full-batch minibatch:
    # the 4-card gradient is the pmean of equal-size shard means, i.e. the
    # global-batch gradient, up to summation order.
    pcfg = PPOConfig(num_envs=FOUR_ENVS, num_steps=16, num_epochs=2,
                     num_minibatches=1, hidden=(128, 128))
    res = {}
    for tag, mesh in (("1 card", None), ("4 cards", env_mesh(devs))):
        tr = PPOTrainer(env, pcfg, mesh=mesh)
        r = tr.init(jax.random.key(0))
        p = dict(r.params["params"])
        p["log_std"] = jnp.full_like(p["log_std"], -30.0)
        r = r.replace(params={"params": p},
                      opt_state=tr.tx.init({"params": p}))
        if mesh is not None:
            from pdecontrolgym_jax.parallel.mesh import put_global
            from jax.sharding import PartitionSpec as P
            r = r.replace(params=put_global(r.params, mesh, P()),
                          opt_state=put_global(r.opt_state, mesh, P()))
        step = tr.make_train_step()
        t0 = time.perf_counter()
        r, m = run(r, step)
        res[tag] = (r.params, float(np.asarray(m["loss"])),
                    time.perf_counter() - t0)
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(res["4 cards"][0]),
                    jax.tree_util.tree_leaves(res["1 card"][0])):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        worst = max(worst, float(np.max(np.abs(a - b))))
    ck = {t: float(sum(np.abs(np.asarray(x, np.float64)).sum()
                       for x in jax.tree_util.tree_leaves(v[0])))
          for t, v in res.items()}
    # Adam moves a parameter by at most ~lr per update; the two runs may
    # differ only by summation order, which Adam can amplify on near-zero
    # gradients, so allow one lr per update for those
    ppo_tol = pcfg.lr * iters * pcfg.num_epochs
    print(f"(four) ppo {iters} train steps: param checksum 1 card "
          f"{ck['1 card']:.9g}, 4 cards {ck['4 cards']:.9g}; max param diff "
          f"{worst:.3e} (tol {ppo_tol:.1e}); loss {res['1 card'][1]:.6g} vs "
          f"{res['4 cards'][1]:.6g}; wall {res['1 card'][2]:.2f} s vs "
          f"{res['4 cards'][2]:.2f} s incl. compile", flush=True)
    check(worst <= ppo_tol, f"(four) ppo params differ by {worst:.3e}")

    # SAC: exploration noise and replay samples are drawn per shard, so the
    # runs are two valid SAC runs on the same global batch, not the same
    # arithmetic: each Adam update moves a parameter by at most ~lr, so after
    # k updates they differ by at most 2·lr·k per parameter.
    scfg = SACConfig(num_envs=FOUR_ENVS, steps_per_iter=4, updates_per_iter=4,
                     batch_size=256, buffer_size=FOUR_ENVS * 16,
                     hidden=(128, 128))
    res = {}
    for tag, mesh in (("1 card", None), ("4 cards", env_mesh(devs))):
        tr = SACTrainer(env, scfg, mesh=mesh)
        r = tr.init(jax.random.key(0))
        step = tr.make_train_step()
        t0 = time.perf_counter()
        r, m = run(r, step)
        res[tag] = (r.actor_params, float(np.asarray(m["critic_loss"])),
                    time.perf_counter() - t0)
        check(np.isfinite(res[tag][1]), f"(four) sac {tag}: critic loss")
    worst = max(float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
                for a, b in zip(jax.tree_util.tree_leaves(res["4 cards"][0]),
                                jax.tree_util.tree_leaves(res["1 card"][0])))
    sac_tol = 2 * scfg.lr * iters * scfg.updates_per_iter * 1.01
    ck = {t: float(sum(np.abs(np.asarray(x, np.float64)).sum()
                       for x in jax.tree_util.tree_leaves(v[0])))
          for t, v in res.items()}
    print(f"(four) sac {iters} train steps: actor checksum 1 card "
          f"{ck['1 card']:.9g}, 4 cards {ck['4 cards']:.9g}; max param diff "
          f"{worst:.3e} (tol {sac_tol:.1e}); critic loss {res['1 card'][1]:.6g}"
          f" vs {res['4 cards'][1]:.6g}", flush=True)
    check(worst <= sac_tol, f"(four) sac params differ by {worst:.3e}")

    # spatially sharded transport on a large grid, (env=1, x=4)
    nx = 4096
    scfg1 = Boundary1DConfig(T=0.5, dt=1e-4, X=1.0, dx=1.0 / nx,
                             control_sample_rate=0.1, backend="xla")
    senv_base = TransportEnv(scfg1, TunedReward1D(scfg1.nt - 1))
    senv = make_sharded_env(senv_base, env_spatial_mesh(4, devs))
    policy = lambda obs, key: 0.1 * obs[:, :1]
    f_s = jax.jit(lambda k: rollout(senv, policy, 64, 5, k))
    f_u = jax.jit(lambda k: rollout(senv_base, policy, 64, 5, k))
    t_s = timed(f_s, jax.random.key(3), repeats=2)
    t_u = timed(f_u, jax.random.key(3), repeats=2)
    (ss, _), outs_s = t_s[2]
    (su, _), outs_u = t_u[2]
    # the state is the same arithmetic; the rewards read L2 norms reduced
    # across the four cards in another order, and the tuned reward's
    # differences of norms amplify that (the CPU test uses 1e-4 too)
    d_u, d_r = rel(ss.u, su.u), rel(outs_s.reward, outs_u.reward)
    print(f"(four) spatial transport nx={nx}, 64 envs x 5 intervals over "
          f"(env=1, x=4): state rel diff {d_u:.3e} (tol 1e-5), reward rel "
          f"diff {d_r:.3e} (tol 1e-4); best {t_s[1] * 1e3:.3f} ms sharded vs "
          f"{t_u[1] * 1e3:.3f} ms on one card", flush=True)
    check(d_u <= 1e-5 and d_r <= 1e-4, "(four) spatial rollout differs")
    check(tuple(ss.u.sharding.spec)[1:2] == ("x",),
          f"(four) grid not sharded over x: {ss.u.sharding.spec}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    name = card()
    print(f"card: {name}; jax {jax.__version__}; devices "
          f"{[d.device_kind for d in jax.devices()]}; compile cache {cache}",
          flush=True)
    t0 = time.perf_counter()
    try:
        four_cards() if args.four else one_card()
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(f"card: {name}; all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
