"""SAC trainer, eval harness, checkpointing."""

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.eval import compare_controllers, episode_returns
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def _env():
    cfg = Boundary1DConfig(
        T=0.5, dt=1e-3, X=1.0, dx=1e-2, control_sample_rate=0.05,
        limit_pde_state_size=True, max_state_value=1e6,
    )
    return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2, lookback=50))


def test_sac_trains_and_is_finite():
    env = _env()
    cfg = SACConfig(num_envs=8, buffer_size=2048, batch_size=64,
                    steps_per_iter=4, updates_per_iter=2, hidden=(32, 32))
    trainer = SACTrainer(env, cfg)
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    for _ in range(4):
        runner, metrics = step(runner)
    assert np.isfinite(float(metrics["mean_reward"]))
    assert np.isfinite(float(metrics["critic_loss"]))
    assert int(runner.buffer.size) == 4 * 4 * 8
    # deterministic policy produces bounded actions
    act = trainer.policy(runner.actor_params)(runner.obs)
    assert np.abs(np.asarray(act)).max() <= 1.0


def test_eval_harness_episode_returns():
    env = _env()
    from pdecontrolgym_jax.agents.backstepping import transport_control, transport_kernel

    nx = 100
    sp = jnp.linspace(env.config.dx, 1.0, nx)
    kern = transport_kernel(
        (5 * jnp.cos(7.35 * jnp.arccos(jnp.clip(sp, -1, 1)))).astype(jnp.float32),
        env.config.dx,
    )
    controllers = {
        "backstepping": lambda o, k: jax.vmap(
            lambda ob: transport_control(kern, ob, env.config.dx)
        )(o),
        "zero": lambda o, k: jnp.zeros(o.shape[0]),
    }
    res = compare_controllers(env, controllers, num_episodes=16, max_steps=12)
    assert set(res) == {"backstepping", "zero"}
    assert np.isfinite(res["backstepping"]["mean_return"])
    assert np.isfinite(res["zero"]["mean_return"])
    assert res["backstepping"]["mean_length"] == 10.0  # 0.5s / 0.05s intervals


def test_checkpoint_roundtrip(tmp_path):
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
    from pdecontrolgym_jax.utils import restore, save

    env = _env()
    trainer = PPOTrainer(env, PPOConfig(num_envs=8, num_steps=4, hidden=(16, 16),
                                        num_minibatches=2, num_epochs=1))
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    runner, _ = step(runner)
    path = str(tmp_path / "ckpt")
    save(path, runner)
    template = trainer.init(jax.random.key(1))
    template, _ = step(template)  # match opt_state structure
    restored = restore(path, template)
    a = jax.tree_util.tree_leaves(runner.params)[0]
    b = jax.tree_util.tree_leaves(restored.params)[0]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_metrics_logger(tmp_path):
    import json
    from pdecontrolgym_jax.utils import MetricsLogger

    logger = MetricsLogger(str(tmp_path), tensorboard=False)
    logger.log(0, {"mean_reward": jnp.float32(1.5)})
    logger.log(10, {"mean_reward": 2.0, "loss": 0.3})
    logger.close()
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert rows[0]["mean_reward"] == 1.5 and rows[1]["step"] == 10


def test_sac_sharded_eight_devices():
    from pdecontrolgym_jax.parallel.mesh import env_mesh

    assert jax.device_count() >= 8
    env = _env()
    mesh = env_mesh(jax.devices()[:8])
    cfg = SACConfig(num_envs=32, buffer_size=1024, batch_size=32,
                    steps_per_iter=2, updates_per_iter=2, hidden=(16, 16))
    trainer = SACTrainer(env, cfg, mesh=mesh)
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    for _ in range(2):
        runner, m = step(runner)
    assert np.isfinite(float(m["mean_reward"]))
    # params replicated; buffer stays sharded over the env axis
    p = jax.tree_util.tree_leaves(runner.actor_params)[0]
    assert p.sharding.is_fully_replicated
    assert not runner.buffer.obs.sharding.is_fully_replicated
    assert int(runner.buffer.size) == 2 * 2 * (32 // 8)  # per-shard count


def test_sac_ring_write_edge_cases():
    """Review-finding pins for the in-place ring write (round 5):

    1. capacity rounds UP to whole iterations, so the contiguous fast path
       is the default for any buffer_size >= one iteration;
    2. an OFF-LATTICE restored ptr lattice-snaps instead of letting
       dynamic_update_slice clamp at the ring end (placement corruption);
    3. a ring SMALLER than one iteration deterministically keeps the LAST
       cap transitions (the old per-step sequential-overwrite outcome).
    """
    env = _env()

    # (1) rounding: 100 -> 128 with rows = 8*4 = 32
    cfg = SACConfig(num_envs=8, buffer_size=100, batch_size=16,
                    steps_per_iter=4, updates_per_iter=1, hidden=(16, 16))
    trainer = SACTrainer(env, cfg)
    assert trainer.cfg.buffer_size == 128
    runner = trainer.init(jax.random.key(0))

    # (2) off-lattice ptr (e.g. restored from a different steps_per_iter):
    # after one collect, the write must land inside the ring on the
    # lattice and ptr must be re-normalized — no end-clamp, no stale rows
    # claimed fresh by the accounting
    runner = runner.replace(buffer=runner.buffer.replace(
        ptr=jnp.asarray(113, jnp.int32)))  # 113 % 32 != 0, 113+32 > 128
    _, _, buffer, _ = trainer._collect(runner, jax.random.key(1))
    assert int(buffer.ptr) == (96 + 32) % 128  # snapped to floor lattice
    rows = np.asarray(buffer.obs[96:128])
    assert np.abs(rows).sum() > 0  # the snapped region actually got data

    # (3) sub-iteration ring: rows = 8*4 = 32 > cap = 24 -> keeps exactly
    # the LAST 24 transitions in ring order
    cfg2 = SACConfig(num_envs=8, buffer_size=24, batch_size=8,
                     steps_per_iter=4, updates_per_iter=1, hidden=(16, 16))
    trainer2 = SACTrainer(env, cfg2)
    assert trainer2.cfg.buffer_size == 24  # not rounded (below one iter)
    runner2 = trainer2.init(jax.random.key(2))
    _, _, buf2, _ = trainer2._collect(runner2, jax.random.key(3))
    assert int(buf2.ptr) == 32 % 24
    assert int(buf2.size) == 24
    # rewards of the last 24 transitions (steps 1..3 of the 8-env x 4-step
    # trajectory) all present; re-derive via a reference collect with a
    # large ring
    cfg_big = SACConfig(num_envs=8, buffer_size=64, batch_size=8,
                        steps_per_iter=4, updates_per_iter=1,
                        hidden=(16, 16))
    trainer_big = SACTrainer(env, cfg_big)
    runner_big = trainer_big.init(jax.random.key(2))
    _, _, buf_big, _ = trainer_big._collect(runner_big, jax.random.key(3))
    want = np.asarray(buf_big.reward[8:32])  # last 24 of the 32 rows
    got = np.roll(np.asarray(buf2.reward), -int(32 % 24))[:24]
    # ring position p holds global row 8 + p' where p' is ring order from
    # the oldest surviving transition
    np.testing.assert_allclose(np.sort(got), np.sort(want), rtol=1e-6)
