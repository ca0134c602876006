"""On-device SAC — the batched counterpart of the reference's SB3 SAC usage
(``examples/transportPDE/transport1Dsac.py``, ``reactionDiffusion1Dsac.py``,
``NavierStokes/NS2Dsac.py``).

Everything lives in one jitted train step: a device-resident circular replay
buffer, tanh-squashed Gaussian actor, twin Q critics with target polyak
averaging, and learnable temperature. Env interaction and gradient updates
share the device; nothing crosses the host boundary during training.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax

from pdecontrolgym_jax.agents.networks import dense, mlp_init
from pdecontrolgym_jax.core import pytree


@dataclasses.dataclass(frozen=True)
class SACConfig:
    lr: float = 3e-4
    num_envs: int = 64
    buffer_size: int = 100_000
    batch_size: int = 256  # per-shard when mesh-sharded (global batch = batch_size x shards)
    gamma: float = 0.99
    tau: float = 0.005
    steps_per_iter: int = 8  # env steps collected per train iteration
    updates_per_iter: int = 8
    hidden: tuple = (128, 128)
    init_alpha: float = 0.1
    learn_alpha: bool = True
    # PDE-control rewards are O(100); scaling keeps Q targets conditioned
    reward_scale: float = 1.0
    action_low: float = -1.0
    action_high: float = 1.0


class Actor:
    """ReLU MLP with a mean head and a clipped log-std head."""

    def __init__(self, action_dim: int, hidden: tuple):
        self.action_dim = action_dim
        self.hidden = tuple(hidden)

    def init(self, key, obs):
        h, a = self.hidden, self.action_dim
        p = mlp_init(key, (), 0, obs.shape[-1], h + (a,))
        p.update(mlp_init(key, (), len(h) + 1, h[-1], (a,)))
        return {"params": p}

    def apply(self, params, obs):
        p, n = params["params"], len(self.hidden)
        x = obs
        for i in range(n):
            x = jax.nn.relu(dense(p[f"Dense_{i}"], x))
        mean = dense(p[f"Dense_{n}"], x)
        log_std = jnp.clip(dense(p[f"Dense_{n + 1}"], x), -5.0, 2.0)
        return mean, log_std


class TwinCritic:
    """Two independent ReLU Q-networks over ``concat(obs, action)``."""

    def __init__(self, hidden: tuple):
        self.hidden = tuple(hidden)

    def init(self, key, obs, action):
        fan_in = obs.shape[-1] + action.shape[-1]
        return {"params": {
            name: mlp_init(key, (name,), 0, fan_in, self.hidden + (1,))
            for name in ("Critic_0", "Critic_1")
        }}

    def apply(self, params, obs, action):
        n = len(self.hidden)

        def q(p):
            x = jnp.concatenate([obs, action], axis=-1)
            for i in range(n):
                x = jax.nn.relu(dense(p[f"Dense_{i}"], x))
            return dense(p[f"Dense_{n}"], x).squeeze(-1)

        p = params["params"]
        return q(p["Critic_0"]), q(p["Critic_1"])


def _squash(mean, log_std, key):
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mean.shape, mean.dtype)
    pre = mean + std * eps
    act = jnp.tanh(pre)
    logp = jnp.sum(
        -0.5 * eps**2 - log_std - 0.5 * jnp.log(2 * jnp.pi)
        - jnp.log(1.0 - act**2 + 1e-6),
        axis=-1,
    )
    return act, logp


@pytree.dataclass
class Buffer:
    obs: jnp.ndarray
    action: jnp.ndarray
    reward: jnp.ndarray
    next_obs: jnp.ndarray
    done: jnp.ndarray
    ptr: jnp.ndarray
    size: jnp.ndarray


@pytree.dataclass
class SACRunner:
    actor_params: Any
    critic_params: Any
    target_params: Any
    log_alpha: jnp.ndarray
    opt_states: Any
    buffer: Buffer
    env_state: Any
    obs: jnp.ndarray
    key: jax.Array


class SACTrainer:
    """``mesh=`` shards envs AND the replay buffer over a 1D env mesh (each
    shard keeps its own replay slice — standard distributed off-policy
    training); params/targets replicate and gradients ``pmean``-reduce, like
    the PPO trainer."""

    def __init__(self, env, config: SACConfig = SACConfig(), mesh=None):
        self.env = env
        # Round the ring capacity UP to a whole number of iterations so the
        # in-place contiguous ring write (the train-step fast path in
        # ``_collect``) is the DEFAULT, not a divisibility accident; the
        # write pointer then always stays on the rows-lattice. Rings
        # smaller than one iteration (tiny demo configs) keep their size
        # and take the scatter fallback, which retains only the last
        # ``buffer_size`` transitions — the old per-step semantics.
        rows = config.num_envs * config.steps_per_iter
        if config.buffer_size >= rows and config.buffer_size % rows:
            config = dataclasses.replace(
                config, buffer_size=-(-config.buffer_size // rows) * rows
            )
        self.cfg = config
        self.mesh = mesh
        self.adim = env.action_dim
        self.actor = Actor(self.adim, config.hidden)
        self.critic = TwinCritic(config.hidden)
        self.tx = optax.adam(config.lr)
        self.target_entropy = -float(self.adim)
        # batched env step (the env's step_batch + gated autoreset) — same
        # swap as PPOTrainer; noise-free envs only (the
        # check walks the wrapper chain)
        from pdecontrolgym_jax.parallel.rollout import batch_step, env_noise_fn

        if env_noise_fn(env) is None:
            self._env_step = batch_step(env, autoreset=True)
        else:
            self._env_step = lambda state, actions, key: jax.vmap(
                env.autoreset_step
            )(state, actions, jax.random.split(key, actions.shape[0]))
        if mesh is not None:
            if config.num_envs % mesh.size or config.buffer_size % mesh.size:
                raise ValueError(
                    "num_envs and buffer_size must divide over the mesh"
                )

    def _pmean(self, x):
        if self.mesh is None:
            return x
        from pdecontrolgym_jax.parallel.mesh import ENV_AXIS

        return jax.lax.pmean(x, ENV_AXIS)

    def _scale(self, a):
        c = self.cfg
        return c.action_low + 0.5 * (a + 1.0) * (c.action_high - c.action_low)

    def init(self, key: jax.Array) -> SACRunner:
        cfg = self.cfg
        key, k1, k2, k3 = jax.random.split(key, 4)
        env_state, obs = jax.vmap(self.env.init)(
            jax.random.split(k3, cfg.num_envs)
        )
        odim = obs.shape[-1]
        actor_params = self.actor.init(k1, obs[:1])
        critic_params = self.critic.init(k2, obs[:1], jnp.zeros((1, self.adim)))
        log_alpha = jnp.log(jnp.asarray(cfg.init_alpha))
        opt_states = (
            self.tx.init(actor_params),
            self.tx.init(critic_params),
            self.tx.init(log_alpha),
        )
        n = cfg.buffer_size
        buffer = Buffer(
            obs=jnp.zeros((n, odim)),
            action=jnp.zeros((n, self.adim)),
            reward=jnp.zeros((n,)),
            next_obs=jnp.zeros((n, odim)),
            done=jnp.zeros((n,), jnp.bool_),
            ptr=jnp.zeros((), jnp.int32),
            size=jnp.zeros((), jnp.int32),
        )
        runner = SACRunner(
            actor_params=actor_params,
            critic_params=critic_params,
            target_params=critic_params,
            log_alpha=log_alpha,
            opt_states=opt_states,
            buffer=buffer,
            env_state=env_state,
            obs=obs,
            key=key,
        )
        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P

            # put_global handles multi-process meshes too (device_put rejects
            # non-addressable shardings) — same placement as the PPO trainer,
            # plus the per-process replay-buffer shard
            from pdecontrolgym_jax.parallel.mesh import ENV_AXIS, put_global

            sh, rp = P(ENV_AXIS), P()
            put = lambda t, s_: put_global(t, self.mesh, s_)
            runner = SACRunner(
                actor_params=put(runner.actor_params, rp),
                critic_params=put(runner.critic_params, rp),
                target_params=put(runner.target_params, rp),
                log_alpha=put(runner.log_alpha, rp),
                opt_states=put(runner.opt_states, rp),
                buffer=Buffer(
                    obs=put(buffer.obs, sh),
                    action=put(buffer.action, sh),
                    reward=put(buffer.reward, sh),
                    next_obs=put(buffer.next_obs, sh),
                    done=put(buffer.done, sh),
                    ptr=put(buffer.ptr, rp),
                    size=put(buffer.size, rp),
                ),
                env_state=put(runner.env_state, sh),
                obs=put(runner.obs, sh),
                key=put(runner.key, rp),
            )
        return runner

    def make_train_step(self):
        if self.mesh is None:
            return jax.jit(self._train_step)
        from jax.sharding import PartitionSpec as P

        from pdecontrolgym_jax.parallel.mesh import ENV_AXIS

        shard, repl = P(ENV_AXIS), P()
        buf_spec = Buffer(obs=shard, action=shard, reward=shard,
                          next_obs=shard, done=shard, ptr=repl, size=repl)
        in_specs = SACRunner(
            actor_params=repl, critic_params=repl, target_params=repl,
            log_alpha=repl, opt_states=repl, buffer=buf_spec,
            env_state=shard, obs=shard, key=repl,
        )
        sharded = jax.shard_map(
            self._train_step, mesh=self.mesh,
            in_specs=(in_specs,), out_specs=(in_specs, repl),
            check_vma=False,
        )
        return jax.jit(sharded)

    def _collect(self, runner: SACRunner, key):
        cfg = self.cfg

        def env_step(carry, step_key):
            env_state, obs = carry
            a_key, r_key = jax.random.split(step_key)
            mean, log_std = self.actor.apply(runner.actor_params, obs)
            act, _ = _squash(mean, log_std, a_key)
            env_action = self._scale(act)
            ea = env_action[:, 0] if self.adim == 1 else env_action
            env_state, out = self._env_step(env_state, ea, r_key)
            done = jnp.logical_or(out.terminated, out.truncated)
            data = (obs, act, out.reward, out.obs, done)
            return (env_state, out.obs), data

        keys = jax.random.split(key, cfg.steps_per_iter)
        (env_state, obs), traj = jax.lax.scan(
            env_step, (runner.env_state, runner.obs), keys
        )
        # ---- one ring write per iteration ----
        # The previous per-step `.at[(ptr+arange) % cap].set(...)` writes
        # were SCATTERS with computed indices, which XLA cannot prove
        # in-place on the scan-carried ring: the profiler showed two full
        # ring copies (2 x 134 MB at the bench config) per env step —
        # fusion.393/397, ~10 ms of the 33 ms train iteration. Collecting
        # the (steps, n, ...) trajectory first (33 MB) and committing it as
        # ONE contiguous dynamic_update_slice makes the update in-place.
        # The slice placement is exact when cap divides into whole
        # iterations (ptr then stays on the rows-lattice: init writes 0,
        # every iteration advances by `rows`); otherwise fall back to the
        # scatter form, whose placement handles arbitrary wrap.
        buffer = runner.buffer
        n_local = runner.obs.shape[0]
        cap = buffer.obs.shape[0]
        rows = n_local * cfg.steps_per_iter
        flat = jax.tree_util.tree_map(
            lambda x: x.reshape((rows,) + x.shape[2:]), traj
        )
        flat = (flat[0], flat[1], flat[2] * cfg.reward_scale, flat[3],
                flat[4])
        names = ("obs", "action", "reward", "next_obs", "done")
        # match ring dtypes explicitly (the old scatter .set cast implicitly;
        # dynamic_update_slice does not — e.g. f64 env rewards under x64
        # tests into the f32 ring)
        flat = tuple(
            val.astype(getattr(buffer, name).dtype)
            for name, val in zip(names, flat)
        )
        if cap % rows == 0:
            # snap the write start onto the rows-lattice: buffers this
            # trainer initializes are always on it (init writes 0, each
            # iteration advances by rows), but a runner restored from a
            # DIFFERENT steps_per_iter/num_envs config may not be —
            # dynamic_update_slice would then CLAMP at the ring end instead
            # of wrapping, silently corrupting placement vs the size/ptr
            # accounting. Snapping costs one transitional overwrite of an
            # interchangeable ring region and re-normalizes ptr permanently.
            start = buffer.ptr - buffer.ptr % rows
            zero = jnp.zeros((), buffer.ptr.dtype)
            updates = {
                name: jax.lax.dynamic_update_slice(
                    getattr(buffer, name), val,
                    (start,) + (zero,) * (val.ndim - 1),
                )
                for name, val in zip(names, flat)
            }
            new_ptr = (start + rows) % cap
        else:
            # scatter fallback for non-dividing capacities. When the ring
            # is smaller than one iteration's data, keep only the LAST
            # ``cap`` transitions (static tail slice): a self-overlapping
            # scatter index vector would make which duplicate survives
            # implementation-defined, while the tail slice reproduces the
            # old per-step sequential-overwrite outcome exactly.
            eff = min(rows, cap)
            tail = tuple(v[rows - eff:] for v in flat)
            idx = (buffer.ptr + (rows - eff) + jnp.arange(eff)) % cap
            updates = {
                name: getattr(buffer, name).at[idx].set(val)
                for name, val in zip(names, tail)
            }
            new_ptr = (buffer.ptr + rows) % cap
        buffer = buffer.replace(
            ptr=new_ptr,
            size=jnp.minimum(buffer.size + rows, cap),
            **updates,
        )
        return env_state, obs, buffer, traj[2].mean()

    def _update(self, runner: SACRunner, buffer: Buffer, key):
        cfg = self.cfg

        def one_update(carry, up_key):
            actor_params, critic_params, target_params, log_alpha, opts = carry
            s_key, a_key, a2_key = jax.random.split(up_key, 3)
            idx = jax.random.randint(s_key, (cfg.batch_size,), 0, buffer.size)
            batch = jax.tree_util.tree_map(
                lambda x: x[idx] if x.ndim else x,
                (buffer.obs, buffer.action, buffer.reward, buffer.next_obs,
                 buffer.done),
            )
            obs, act, rew, nobs, done = batch
            alpha = jnp.exp(log_alpha)

            # critic target
            nmean, nlstd = self.actor.apply(actor_params, nobs)
            nact, nlogp = _squash(nmean, nlstd, a2_key)
            q1t, q2t = self.critic.apply(target_params, nobs, nact)
            target = rew + cfg.gamma * (1.0 - done) * (
                jnp.minimum(q1t, q2t) - alpha * nlogp
            )
            target = jax.lax.stop_gradient(target)

            def critic_loss(cp):
                q1, q2 = self.critic.apply(cp, obs, act)
                return jnp.mean((q1 - target) ** 2 + (q2 - target) ** 2)

            closs, cgrads = jax.value_and_grad(critic_loss)(critic_params)
            cgrads = self._pmean(cgrads)
            cupd, copt = self.tx.update(cgrads, opts[1], critic_params)
            critic_params = optax.apply_updates(critic_params, cupd)

            def actor_loss(ap):
                mean, lstd = self.actor.apply(ap, obs)
                a, logp = _squash(mean, lstd, a_key)
                q1, q2 = self.critic.apply(critic_params, obs, a)
                return jnp.mean(alpha * logp - jnp.minimum(q1, q2)), logp

            (aloss, logp), agrads = jax.value_and_grad(actor_loss, has_aux=True)(
                actor_params
            )
            agrads = self._pmean(agrads)
            aupd, aopt = self.tx.update(agrads, opts[0], actor_params)
            actor_params = optax.apply_updates(actor_params, aupd)

            if cfg.learn_alpha:
                def alpha_loss(la):
                    return -jnp.mean(
                        jnp.exp(la) * jax.lax.stop_gradient(logp + self.target_entropy)
                    )

                _, lgrad = jax.value_and_grad(alpha_loss)(log_alpha)
                lgrad = self._pmean(lgrad)
                lupd, lopt = self.tx.update(lgrad, opts[2], log_alpha)
                log_alpha = optax.apply_updates(log_alpha, lupd)
            else:
                lopt = opts[2]

            target_params = jax.tree_util.tree_map(
                lambda t, s: (1.0 - cfg.tau) * t + cfg.tau * s,
                target_params, critic_params,
            )
            return (actor_params, critic_params, target_params, log_alpha,
                    (aopt, copt, lopt)), (closs, aloss)

        keys = jax.random.split(key, cfg.updates_per_iter)
        carry = (runner.actor_params, runner.critic_params,
                 runner.target_params, runner.log_alpha, runner.opt_states)
        carry, losses = jax.lax.scan(one_update, carry, keys)
        return carry, losses

    def _train_step(self, runner: SACRunner):
        if self.mesh is not None:
            from pdecontrolgym_jax.parallel.mesh import ENV_AXIS
            local = jax.random.fold_in(runner.key, jax.lax.axis_index(ENV_AXIS))
            _, c_key, u_key = jax.random.split(local, 3)
            key, _ = jax.random.split(runner.key)  # replicated stream advances
        else:
            key, c_key, u_key = jax.random.split(runner.key, 3)
        env_state, obs, buffer, mean_rew = self._collect(runner, c_key)
        (ap, cp, tp, la, opts), (closs, aloss) = self._update(
            runner.replace(buffer=buffer), buffer, u_key
        )
        new_runner = SACRunner(
            actor_params=ap, critic_params=cp, target_params=tp,
            log_alpha=la, opt_states=opts, buffer=buffer,
            env_state=env_state, obs=obs, key=key,
        )
        metrics = {
            "mean_reward": self._pmean(mean_rew),
            "critic_loss": self._pmean(closs.mean()),
            "actor_loss": self._pmean(aloss.mean()),
            "alpha": jnp.exp(la),
        }
        return new_runner, metrics

    def train(self, key: jax.Array, num_iterations: int, log_every: int = 20,
              callback=None, eval_fn=None, eval_every: int = 25,
              select_best: bool = True):
        """Training loop with optional eval-based checkpoint selection
        (same contract as ``PPOTrainer.train``); ``eval_fn(actor_params) ->
        float``, higher = better."""
        runner = self.init(key)
        train_step = self.make_train_step()
        best_score, best_runner = -float("inf"), None
        for it in range(num_iterations):
            runner, metrics = train_step(runner)
            last = it == num_iterations - 1
            if eval_fn is not None and (it % eval_every == 0 or last):
                score = float(eval_fn(runner.actor_params))
                if score > best_score:
                    best_score = score
                    # snapshot the WHOLE runner (actor + critic + targets +
                    # opt states + replay buffer): restoring best actor
                    # params alone would leave the critic/opt-state at the
                    # last iteration — inconsistent for resumed training
                    best_runner = jax.device_get(runner)
                if callback is not None:
                    callback(it, {**jax.device_get(metrics), "eval": score,
                                  "best_eval": best_score})
                    continue
            if callback is not None and (it % log_every == 0 or last):
                callback(it, jax.device_get(metrics))
        if select_best and best_runner is not None:
            runner = jax.device_put(best_runner)
        return runner

    def policy(self, actor_params, deterministic: bool = True):
        def act(obs, key=None):
            mean, log_std = self.actor.apply(actor_params, obs)
            if deterministic or key is None:
                a = jnp.tanh(mean)
            else:
                a, _ = _squash(mean, log_std, key)
            a = self._scale(a)
            return a[..., 0] if self.adim == 1 else a

        return act
