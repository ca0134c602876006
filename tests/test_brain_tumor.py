"""Brain-tumor env + therapy staging parity vs the reference."""

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    TherapyEnv,
    GROWTH, THERAPY, POST_THERAPY,
)
from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward

from reference_loader import load_reference_module

PARAMS = dict(T=600.0, dt=1.0, X=200.0, dx=1.0)
NX = 201


def _ic(X=200.0, nx=NX):
    xs = np.linspace(0, X, nx)
    return 0.8 * 1e5 * np.exp(-0.25 * xs**2)


def _ref(total_dosage=61.2):
    bt = load_reference_module("pde_control_gym.src.environments1d.brain_tumor_env")
    rew = load_reference_module("pde_control_gym.src.rewards.brain_tumor_reward")
    env = bt.BrainTumor1D(
        reward_class=rew.BrainTumorReward(),
        reset_init_condition_func=_ic,
        total_dosage=total_dosage,
        verbose=False,
        normalize=True,
        **PARAMS,
    )
    return bt, env


def _jax_env(total_dosage=61.2):
    cfg = BrainTumorConfig(total_dosage=total_dosage, dtype=jnp.float64, **PARAMS)
    return BrainTumorEnv(cfg, BrainTumorReward())


def test_staged_episode_parity_paper_schedule():
    """Full episode: growth, a 1.8 Gy/day schedule through therapy, then
    post-therapy decline to death. Trajectories, stages, rewards, metrics."""
    bt, ref = _ref()
    robs, _ = ref.reset()
    ref.t_benchmark = 100  # pretend benchmark so rewards are non-trivial

    env = _jax_env()
    step = jax.jit(env.step)
    state, tobs = env.init_from(_ic(), t_benchmark=100)
    np.testing.assert_allclose(robs, np.asarray(tobs), rtol=1e-12)

    dose_fraction = 1.8 / 61.2
    rterm = rtrunc = False
    steps = 0
    while not (rterm or rtrunc) and steps < 650:
        a = dose_fraction if ref.stage == "Therapy" else 0.0
        robs, rrew, rterm, rtrunc, rinfo = ref.step(a)
        state, out = step(state, jnp.float64(a))
        steps += 1
        np.testing.assert_allclose(robs, np.asarray(out.obs), rtol=1e-9, atol=1e-6)
        assert rinfo["stage"] == ("Growth", "Therapy", "Post-Therapy")[int(out.info["stage"])]
        np.testing.assert_allclose(rrew, float(out.reward), rtol=1e-6, atol=1e-9)
        assert (rterm, rtrunc) == (bool(out.terminated), bool(out.truncated))

    assert rtrunc  # patient dies before the horizon in this schedule
    assert ref.cDeathDay == int(state.death_day)
    assert ref.simulationDays == int(state.simulation_days)
    assert ref.firstTherapyDay == int(state.first_therapy_day)
    assert ref.firstPostTherapyDay == int(state.first_post_therapy_day)


def test_therapy_wrapper_benchmark_and_episode_match():
    bt, ref_base = _ref()
    ref_wrap = bt.TherapyWrapper(ref_base, weekends=False, verbose=False)
    ref_tb = ref_wrap.benchmark()

    env = _jax_env()
    ther = TherapyEnv(env)
    jax_tb = int(jax.jit(ther.benchmark)(jax.random.key(0)))
    assert ref_tb == jax_tb

    # wrapped episode with a fixed dose fraction
    robs, _ = ref_wrap.reset()
    state, tobs = jax.jit(ther.init, static_argnames="t_benchmark")(
        jax.random.key(0), t_benchmark=jax_tb
    )
    np.testing.assert_allclose(robs, np.asarray(tobs), rtol=1e-9)

    wstep = jax.jit(ther.step)
    rterm = rtrunc = False
    rtotal, ttotal = 0.0, 0.0
    steps = 0
    while not (rterm or rtrunc) and steps < 200:
        robs, rrew, rterm, rtrunc, _ = ref_wrap.step(1.8 / 61.2)
        state, out = wstep(state, jnp.float64(1.8 / 61.2))
        rtotal += rrew
        ttotal += float(out.reward)
        steps += 1
        assert (rterm, rtrunc) == (bool(out.terminated), bool(out.truncated))
        np.testing.assert_allclose(robs, np.asarray(out.obs), rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(rtotal, ttotal, rtol=1e-6)


def test_weekend_breaks_match_reference():
    bt, ref_base = _ref()
    ref_wrap = bt.TherapyWrapper(ref_base, weekends=True, verbose=False)
    tb = ref_wrap.benchmark()

    env = _jax_env()
    ther = TherapyEnv(env, weekends=True)
    robs, _ = ref_wrap.reset()
    state, tobs = jax.jit(ther.init, static_argnames="t_benchmark")(
        jax.random.key(0), t_benchmark=tb
    )
    wstep = jax.jit(ther.step)
    for i in range(12):
        robs, rrew, rterm, rtrunc, _ = ref_wrap.step(0.02)
        state, out = wstep(state, jnp.float64(0.02))
        np.testing.assert_allclose(robs, np.asarray(out.obs), rtol=1e-9, atol=1e-6)
        assert ref_base.time_index == int(state.time_index)  # weekend days inserted identically
        if rterm or rtrunc:
            break


def test_gym_adapter_brain_tumor():
    import gymnasium as gym
    import pdecontrolgym_jax  # noqa: F401
    from pdecontrolgym_jax.compat.adapter import TherapyWrapper as JaxWrapper

    env = gym.make(
        "PDEControlGym-BrainTumor1D",
        reward_class=BrainTumorReward(),
        reset_init_condition_func=_ic,
        total_dosage=61.2,
        verbose=False,
        normalize=True,
        **PARAMS,
    ).unwrapped
    wrap = JaxWrapper(env, weekends=False, verbose=False)
    tb = wrap.benchmark()
    assert tb > 0 and env.t_benchmark == tb
    obs, _ = wrap.reset()
    assert env.stage == "Therapy"
    obs, rew, term, trunc, info = wrap.step(1.8 / 61.2)
    assert info["stage"] in ("Therapy", "Post-Therapy")
    # run a whole wrapped episode; episodic reward = survival - benchmark
    while not (term or trunc):
        obs, rew, term, trunc, info = wrap.step(1.8 / 61.2)
    assert isinstance(rew, float)


# -- fused Pallas kernels (interpret mode on CPU) -----------------------------

# small domain so the while-loops stay fast: detection at
# 5 mm, death at 20 mm, ~60-day episodes
FAST = dict(T=80.0, dt=1.0, X=60.0, dx=1.0, t1_detection_radius=5.0,
            t1_death_radius=20.0, total_dosage=30.0)


def _fast_env(**kw):
    from pdecontrolgym_jax.envs.brain_tumor import BrainTumorConfig

    return BrainTumorEnv(
        BrainTumorConfig(dtype=jnp.float32, **FAST, **kw), BrainTumorReward())


def _assert_state_close(a, b):
    for name in a.__dataclass_fields__:
        av, bv = getattr(a, name), getattr(b, name)
        if av is None:
            assert bv is None
            continue
        np.testing.assert_allclose(
            np.asarray(av), np.asarray(bv), rtol=1e-6, atol=1e-3,
            err_msg=name,
        )


def test_therapy_env_batched_matches_vmap():
    """TherapyEnv init_batch/step_batch (batched fast-forward while-loops)
    vs the vmapped per-env wrapper: Growth hidden in init, Post-Therapy
    swept in step, per-env desynchronized stages."""
    env = _fast_env()
    tx = TherapyEnv(env, t_benchmark=40)
    tp = TherapyEnv(env, t_benchmark=40)
    B = 4
    keys = jax.random.split(jax.random.key(0), B)
    sx, ox = jax.vmap(tx.init)(keys)
    sp, op = tp.init_batch(keys)
    _assert_state_close(sp, sx)
    np.testing.assert_allclose(np.asarray(op), np.asarray(ox),
                               rtol=1e-6, atol=1e-3)
    dose = jnp.asarray([0.1, 0.4, 0.8, 1.0], jnp.float32)
    for day in range(25):
        sx, ox = jax.vmap(lambda s, a: tx.step(s, a))(sx, dose)
        sp, op = tp.step_batch(sp, dose)
        _assert_state_close(sp, sx)
        np.testing.assert_allclose(np.asarray(op.reward),
                                   np.asarray(ox.reward),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(op.terminated),
                                      np.asarray(ox.terminated))
        np.testing.assert_array_equal(np.asarray(op.truncated),
                                      np.asarray(ox.truncated))


def test_wrapper_forwards_therapy_batch_protocol():
    """Wrappers must forward init_batch/autoreset_gate/observe_batch from
    the wrapped env (review finding: hiding autoreset_gate re-ran
    TherapyEnv's Growth fast-forward on every ungated rollout step), and
    DoseTherapyEnv's observe_batch must match its normalized obs
    contract."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdecontrolgym_jax.envs.brain_tumor import (
        BrainTumorConfig, BrainTumorEnv, DoseTherapyEnv)
    from pdecontrolgym_jax.envs.wrappers import FlatObsEnv

    base = BrainTumorEnv(
        BrainTumorConfig(dtype=jnp.float32, **FAST), BrainTumorReward())
    denv = DoseTherapyEnv(base, t_benchmark=40)
    wrapped = FlatObsEnv(denv)
    assert wrapped.autoreset_gate is True
    assert hasattr(wrapped, "init_batch")
    keys = jax.random.split(jax.random.key(0), 3)
    state, obs = wrapped.init_batch(keys)
    # observe_batch(state) must equal the init obs (normalized by k)
    np.testing.assert_allclose(
        np.asarray(wrapped.observe_batch(state)), np.asarray(obs),
        rtol=1e-6)
    assert float(jnp.abs(obs).max()) <= 1.0 + 1e-6  # normalized contract
