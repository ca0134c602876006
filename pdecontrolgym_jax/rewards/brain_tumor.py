"""BrainTumorReward — episodic survival + per-step toxicity penalty.

Reference: ``src/rewards/brain_tumor_reward.py:31-73`` (dual-mode via kwargs,
and NOT exported by any reference ``__init__`` — fixed here):

- episodic (on terminate/truncate): ``time_index − t_benchmark``
- therapy step: ``−50·clip((AD − dmaxsafe(TR)) / (TD − dmaxsafe(TR)), 0, 1)^⅓``
  with the clinical fit ``dmaxsafe(r) = 116·r^−0.685``
- 0 (with a host-side warning in the adapter) while ``t_benchmark`` is unset.

A zero treatment radius makes ``dmaxsafe`` infinite (always safe): the penalty
is defined as 0 there (the reference produces NaN in that corner).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from pdecontrolgym_jax.core.base import RewardCtx
from pdecontrolgym_jax.rewards.base import BaseReward

LAMBDA_TOXIC = 50.0


def dmaxsafe(treatment_radius):
    return 116.0 * treatment_radius**-0.685


def toxicity_penalty(treatment_radius, applied_dosage, total_dosage):
    maxsafe = dmaxsafe(jnp.maximum(treatment_radius, 1e-30))
    ratio = (applied_dosage - maxsafe) / (total_dosage - maxsafe)
    pen = -LAMBDA_TOXIC * jnp.clip(ratio, 0.0, 1.0) ** (1.0 / 3.0)
    return jnp.where(treatment_radius > 0.0, pen, 0.0)


@dataclasses.dataclass(frozen=True)
class BrainTumorReward(BaseReward):
    def __call__(self, ctx: RewardCtx) -> jnp.ndarray:
        e = ctx.extras
        t_benchmark = e["t_benchmark"]
        has_benchmark = t_benchmark >= 0
        episodic = (ctx.time_index - t_benchmark).astype(jnp.float32)
        step_pen = toxicity_penalty(
            e["treatment_radius"], e["applied_dosage"], e["total_dosage"]
        )
        done = jnp.logical_or(ctx.terminated, ctx.truncated)
        return jnp.where(
            has_benchmark, jnp.where(done, episodic, step_pen), 0.0
        )

    # legacy ABC-style signature (brain_tumor_reward.py:31)
    def reward(
        self,
        uVec=None,
        time_index=None,
        terminate=None,
        truncate=None,
        action=None,
        verbose=True,
        **kwargs,
    ):
        t_benchmark = kwargs["t_benchmark"]
        if t_benchmark is None:
            if verbose:
                print("Warning: t_benchmark is not yet set -> returned reward of 0\n")
            return 0
        if terminate or truncate:
            return time_index - t_benchmark
        return float(
            toxicity_penalty(
                kwargs["treatment_radius"],
                kwargs["applied_dosage"],
                kwargs["total_dosage"],
            )
        )
