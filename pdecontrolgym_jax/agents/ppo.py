"""On-device PPO — the batched replacement for the reference's SB3 usage.

The reference trains SB3 PPO against a single Python env for 1e6 steps
(``examples/transportPDE/transport1Dppo.py:80-90``), spending ~99% of wall time
in ``env.step`` (SURVEY §3.4). Here the whole loop — batched env rollout,
GAE, clipped-surrogate minibatch epochs — is ONE jitted program: envs never
leave the device and thousands step in lockstep.

Multi-chip: ``mesh=`` shards the env batch over a 1D ``("env",)`` device mesh
with ``shard_map``; parameters are replicated, gradients are ``pmean``-reduced
across the mesh, so every device applies the identical update (standard data
parallelism, collectives riding ICI).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pdecontrolgym_jax.agents.networks import (
    ActorCritic,
    entropy,
    gaussian_logp,
    sample_action,
)
from pdecontrolgym_jax.core import pytree
from pdecontrolgym_jax.parallel.mesh import ENV_AXIS


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    num_envs: int = 256
    num_steps: int = 16
    num_epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    hidden: tuple = (128, 128)
    # PDE-control rewards are O(100); scaling keeps the value loss from
    # drowning the policy gradient (SB3 users typically wrap VecNormalize)
    reward_scale: float = 1.0
    obs_clip: float = 0.0  # >0: clip observations to [-obs_clip, obs_clip]
    # >0: linearly decay the learning rate to 0 over this many train
    # iterations (counted in optimizer updates = epochs*minibatches per
    # iteration) — late-training step-size noise is what keeps the policy
    # oscillating around its peak instead of settling on it
    anneal_lr_iters: int = 0


@pytree.dataclass
class Runner:
    params: dict
    opt_state: tuple
    env_state: any
    obs: jnp.ndarray
    key: jax.Array


class PPOTrainer:
    def __init__(self, env, config: PPOConfig = PPOConfig(), mesh: Optional[Mesh] = None):
        self.env = env
        self.cfg = config
        self.mesh = mesh
        self.net = ActorCritic(action_dim=env.action_dim, hidden=config.hidden)
        lr = config.lr
        if config.anneal_lr_iters > 0:
            updates_per_iter = config.num_epochs * config.num_minibatches
            lr = optax.linear_schedule(
                config.lr, 0.0, config.anneal_lr_iters * updates_per_iter
            )
        self.tx = optax.chain(
            optax.clip_by_global_norm(config.max_grad_norm),
            optax.adam(lr, eps=1e-5),
        )
        if mesh is not None and config.num_envs % mesh.size != 0:
            raise ValueError(
                f"num_envs={config.num_envs} must divide over mesh size {mesh.size}"
            )
        # Rollout stepping: the batched step (the env's step_batch, e.g. the
        # interval kernel, with gated autoreset) instead of per-env
        # vmap(autoreset_step). Envs with sensing
        # noise (anywhere in the wrapper chain) keep the per-env path: the
        # fused step drops per-env noise keys.
        from pdecontrolgym_jax.parallel.rollout import batch_step, env_noise_fn

        if env_noise_fn(env) is None:
            self._env_step = batch_step(env, autoreset=True)
        else:
            self._env_step = lambda state, actions, key: jax.vmap(
                env.autoreset_step
            )(state, actions, jax.random.split(key, actions.shape[0]))

    # -- initialization -------------------------------------------------------

    def init(self, key: jax.Array) -> Runner:
        cfg = self.cfg
        key, net_key, env_key = jax.random.split(key, 3)
        env_keys = jax.random.split(env_key, cfg.num_envs)
        env_state, obs = jax.vmap(self.env.init)(env_keys)
        if cfg.obs_clip > 0:
            obs = jnp.clip(obs, -cfg.obs_clip, cfg.obs_clip)
        params = self.net.init(net_key, obs[:1])
        opt_state = self.tx.init(params)
        runner = Runner(
            params=params, opt_state=opt_state, env_state=env_state, obs=obs, key=key
        )
        if self.mesh is not None:
            # put_global handles multi-process meshes too (device_put rejects
            # non-addressable shardings): every process runs this same-seed
            # init and contributes the device blocks it owns
            from pdecontrolgym_jax.parallel.mesh import put_global

            runner = Runner(
                params=put_global(runner.params, self.mesh, P()),
                opt_state=put_global(runner.opt_state, self.mesh, P()),
                env_state=put_global(runner.env_state, self.mesh, P(ENV_AXIS)),
                obs=put_global(runner.obs, self.mesh, P(ENV_AXIS)),
                key=put_global(runner.key, self.mesh, P()),
            )
        return runner

    # -- one training iteration ----------------------------------------------

    def make_train_step(self):
        """Returns jitted ``train_step(runner) -> (runner, metrics)``."""
        if self.mesh is None:
            return jax.jit(self._train_step_local)

        spec_shard = P(ENV_AXIS)
        spec_repl = P()
        in_specs = Runner(
            params=spec_repl,
            opt_state=spec_repl,
            env_state=spec_shard,
            obs=spec_shard,
            key=spec_repl,
        )
        sharded = jax.shard_map(
            self._train_step_local,
            mesh=self.mesh,
            in_specs=(in_specs,),
            out_specs=(in_specs, spec_repl),
            check_vma=False,
        )
        return jax.jit(sharded)

    def _train_step_local(self, runner: Runner):
        cfg = self.cfg
        on_mesh = self.mesh is not None
        if on_mesh:
            # per-shard RNG stream; params/opt stay identical across shards
            shard_id = jax.lax.axis_index(ENV_AXIS)
            local_key = jax.random.fold_in(runner.key, shard_id)
        else:
            local_key = runner.key
        key, rollout_key, perm_key = jax.random.split(local_key, 3)

        # ---- rollout ----
        def env_step(carry, step_key):
            env_state, obs = carry
            act_key, reset_key = jax.random.split(step_key)
            mean, log_std, value = self.net.apply(runner.params, obs)
            action, logp = sample_action(mean, log_std, act_key)
            env_action = action[:, 0] if self.env.action_dim == 1 else action
            env_state, out = self._env_step(env_state, env_action, reset_key)
            done = jnp.logical_or(out.terminated, out.truncated)
            next_obs = out.obs
            if cfg.obs_clip > 0:
                next_obs = jnp.clip(next_obs, -cfg.obs_clip, cfg.obs_clip)
            data = (obs, action, logp, value, out.reward * cfg.reward_scale, done)
            return (env_state, next_obs), data

        step_keys = jax.random.split(rollout_key, cfg.num_steps)
        (env_state, last_obs), traj = jax.lax.scan(
            env_step, (runner.env_state, runner.obs), step_keys
        )
        obs_t, act_t, logp_t, val_t, rew_t, done_t = traj

        # ---- GAE ----
        _, _, last_val = self.net.apply(runner.params, last_obs)

        def gae_step(carry, inp):
            gae, next_value = carry
            value, reward, done = inp
            nd = 1.0 - done.astype(jnp.float32)
            delta = reward + cfg.gamma * next_value * nd - value
            gae = delta + cfg.gamma * cfg.gae_lambda * nd * gae
            return (gae, value), gae

        (_, _), adv_t = jax.lax.scan(
            gae_step,
            (jnp.zeros_like(last_val), last_val),
            (val_t, rew_t, done_t),
            reverse=True,
        )
        ret_t = adv_t + val_t

        # ---- minibatch epochs ----
        batch = jax.tree_util.tree_map(
            lambda x: x.reshape((-1,) + x.shape[2:]),
            (obs_t, act_t, logp_t, val_t, adv_t, ret_t),
        )
        batch_size = cfg.num_steps * obs_t.shape[1]
        mb_size = batch_size // cfg.num_minibatches
        # Pack the per-sample scalars (action, logp, value, adv, return)
        # into ONE (N, adim+4) matrix so each epoch's shuffle is TWO gathers
        # (obs + scalars) instead of six: a random-permutation gather of a
        # small (N,) vector is latency-bound, so five separate gathers per
        # epoch cost more than the one packed gather.
        obs_b, act_b, logp_b, val_b, adv_b, ret_b = batch
        adim = act_b.shape[1]
        sc_b = jnp.concatenate(
            [act_b, logp_b[:, None], val_b[:, None], adv_b[:, None],
             ret_b[:, None]], axis=1,
        )

        def unpack_mb(mb):
            obs, sc = mb
            return (obs, sc[:, :adim], sc[:, adim], sc[:, adim + 1],
                    sc[:, adim + 2], sc[:, adim + 3])

        def loss_fn(params, mb):
            obs, act, logp_old, val_old, adv, ret = unpack_mb(mb)
            mean, log_std, value = self.net.apply(params, obs)
            logp = gaussian_logp(act, mean, log_std)
            ratio = jnp.exp(logp - logp_old)
            adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
            pg1 = ratio * adv_n
            pg2 = jnp.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv_n
            pg_loss = -jnp.minimum(pg1, pg2).mean()
            v_clip = val_old + jnp.clip(value - val_old, -cfg.clip_eps, cfg.clip_eps)
            v_loss = 0.5 * jnp.maximum(
                jnp.square(value - ret), jnp.square(v_clip - ret)
            ).mean()
            ent = entropy(log_std).mean()
            total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
            return total, (pg_loss, v_loss, ent)

        def epoch(carry, epoch_key):
            params, opt_state = carry
            perm = jax.random.permutation(epoch_key, batch_size)
            shuffled = (obs_b[perm], sc_b[perm])
            minibatches = jax.tree_util.tree_map(
                lambda x: x.reshape((cfg.num_minibatches, mb_size) + x.shape[1:]),
                shuffled,
            )

            def mb_update(carry, mb):
                params, opt_state = carry
                (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    params, mb
                )
                if on_mesh:
                    grads = jax.lax.pmean(grads, ENV_AXIS)
                    loss = jax.lax.pmean(loss, ENV_AXIS)
                updates, opt_state = self.tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                mb_update, (params, opt_state), minibatches
            )
            return (params, opt_state), losses

        epoch_keys = jax.random.split(perm_key, cfg.num_epochs)
        (params, opt_state), losses = jax.lax.scan(
            epoch, (runner.params, runner.opt_state), epoch_keys
        )

        # report in raw env-reward units (rew_t was scaled for training only)
        mean_rew = rew_t.mean() / cfg.reward_scale
        if on_mesh:
            mean_rew = jax.lax.pmean(mean_rew, ENV_AXIS)
            new_key = runner.key  # replicated stream advances identically
            _, new_key = jax.random.split(new_key)
        else:
            new_key = key

        metrics = {"mean_reward": mean_rew, "loss": losses.mean()}
        if on_mesh:
            metrics["loss"] = jax.lax.pmean(metrics["loss"], ENV_AXIS)
        new_runner = Runner(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=last_obs,
            key=new_key,
        )
        return new_runner, metrics

    # -- convenience ----------------------------------------------------------

    def train(self, key: jax.Array, num_iterations: int, log_every: int = 10,
              callback=None, eval_fn=None, eval_every: int = 25,
              select_best: bool = True):
        """Training loop with optional eval-based checkpoint selection.

        ``eval_fn(params) -> float`` (higher = better) is called every
        ``eval_every`` iterations; with ``select_best`` the returned runner
        carries the best-scoring parameters instead of the last ones — the
        on-device counterpart of the reference's SB3 CheckpointCallback +
        manual best-zip picking (``transport1Dppo.py:80-86``,
        ``Trafficarz1d_tutorial.rst:301`` loads the 1.5e6-of-2e6 checkpoint),
        and the fix for policies that over-train past their peak.
        """
        runner = self.init(key)
        train_step = self.make_train_step()
        best_score, best_runner = -float("inf"), None
        for it in range(num_iterations):
            runner, metrics = train_step(runner)
            last = it == num_iterations - 1
            if eval_fn is not None and (it % eval_every == 0 or last):
                score = float(eval_fn(runner.params))
                if score > best_score:
                    # snapshot the WHOLE runner (params + opt_state + env
                    # state), not just params: restoring best params against
                    # the last iteration's Adam moments would resume training
                    # along stale momentum directions
                    best_score, best_runner = score, jax.device_get(runner)
                if callback is not None:
                    callback(it, {**jax.device_get(metrics), "eval": score,
                                  "best_eval": best_score})
                    continue
            if callback is not None and (it % log_every == 0 or last):
                callback(it, jax.device_get(metrics))
        if select_best and best_runner is not None:
            runner = jax.device_put(best_runner)
        return runner

    def policy(self, params, deterministic: bool = True):
        def act(obs, key=None):
            mean, log_std, _ = self.net.apply(params, obs)
            if deterministic or key is None:
                a = mean
            else:
                a, _ = sample_action(mean, log_std, key)
            return a[..., 0] if self.env.action_dim == 1 else a

        return act
