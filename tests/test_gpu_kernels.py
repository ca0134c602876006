"""The interval kernel compiled for the GPU vs the XLA path, one control
interval at the benchmark widths. Marked ``gpu``: skips without a card."""

import dataclasses

import numpy as np
import pytest

import jax

import bench

pytestmark = pytest.mark.gpu


def _rd_explicit(num_envs, **overrides):
    from pdecontrolgym_jax.envs.reaction_diffusion import (
        ReactionDiffusionConfig, ReactionDiffusionEnv)
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    cfg = ReactionDiffusionConfig(T=0.1, dt=1e-5, X=1.0, dx=5e-3,
                                  control_sample_rate=1e-4, **overrides)
    env = ReactionDiffusionEnv(cfg, TunedReward1D(cfg.nt - 1))
    return env, lambda obs, _k: -0.1 * obs[..., -2]


@pytest.mark.parametrize("build", [
    bench._build_transport, bench._build_burgers,
    bench._build_reaction_diffusion, _rd_explicit,
], ids=["transport128", "burgers256", "rd_implicit257", "rd_explicit201"])
def test_kernel_matches_xla_one_interval(gpu, build):
    from pdecontrolgym_jax.parallel.rollout import batch_init

    n = 4096
    env, policy = build(n)[:2]
    xenv = type(env)(dataclasses.replace(env.config, backend="xla"),
                     env.reward)
    assert env._uses_kernel() and not xenv._uses_kernel()
    s0, o0 = batch_init(env, n)(jax.random.key(0))
    a0 = policy(o0, None)
    sk, ok = jax.jit(env.step_batch)(s0, a0)
    sx, ox = jax.jit(xenv.step_batch)(s0, a0)
    # same f32 scheme; only FMA contraction and summation order differ
    scale = float(np.max(np.abs(np.asarray(sx.u))))
    np.testing.assert_allclose(np.asarray(sk.u), np.asarray(sx.u),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(np.asarray(sk.time_index),
                                  np.asarray(sx.time_index))
    np.testing.assert_allclose(np.asarray(ok.reward), np.asarray(ox.reward),
                               rtol=1e-3, atol=1e-3)
