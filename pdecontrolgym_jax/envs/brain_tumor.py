"""1D glioblastoma (diffusion–proliferation–radiation) env + therapy staging.

PDE: ``c_t = D∇²c + ρc(1−c/K) − R·c(1−c/K)`` with Neumann mirror boundaries
and clipping to [0, K] (``src/environments1d/brain_tumor_env.py:221-245``).
Episodes run a three-stage machine (Growth → Therapy → Post-Therapy,
:123-218): radiation only applies during Therapy, where the action is the
fraction of ``total_dosage`` delivered that day; the radiation field covers the
previous day's simulated-MRI T2 radius + 25 mm margin through the
linear-quadratic BED model ``R = 1 − exp(−α(d + d²/(α/β)))`` (:247-265).

Batched design: the stage machine is masked arithmetic on an int stage field (no
Python control flow), so batches of envs in different stages run in lockstep.
The :class:`TherapyEnv` wrapper reproduces the reference ``TherapyWrapper``
(:386-506): Growth is fast-forwarded inside ``init`` and Post-Therapy inside a
single ``step`` via ``lax.while_loop`` (vmap-compatible), with optional forced
weekend breaks, and ``benchmark()`` computes the zero-treatment survival
baseline ``t_benchmark``.

Grid quirk preserved: this env overrides ``nx = round(X/dx) + 1`` (:52),
unlike the other 1D envs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.core import pytree
from pdecontrolgym_jax.core.base import FunctionalEnv, RewardCtx, StepOut

GROWTH, THERAPY, POST_THERAPY = 0, 1, 2
STAGE_NAMES = ("Growth", "Therapy", "Post-Therapy")


@dataclasses.dataclass(frozen=True)
class BrainTumorConfig:
    T: float = 600.0
    dt: float = 1.0
    X: float = 200.0
    dx: float = 1.0
    t1_detection_threshold: float = 0.8
    t2_detection_threshold: float = 0.16
    dosage_termination_threshold: float = 0.1
    D: float = 0.2
    rho: float = 0.03
    alpha: float = 0.04
    alpha_beta_ratio: float = 10.0
    k: float = 1e5
    t1_detection_radius: float = 15.0
    t1_death_radius: float = 35.0
    total_dosage: float = 61.2
    normalize: bool = False  # accepted but unused, like the reference step()
    dtype: Any = jnp.float32
    @property
    def nt(self) -> int:
        return int(round(self.T / self.dt) + 1)

    @property
    def nx(self) -> int:
        return int(round(self.X / self.dx) + 1)  # brain_tumor_env.py:52


@pytree.dataclass
class BrainTumorState:
    u: jnp.ndarray  # (nx,) tumor cell density
    time_index: jnp.ndarray  # int32 (days)
    stage: jnp.ndarray  # int32: 0 Growth / 1 Therapy / 2 Post-Therapy
    remaining_dosage: jnp.ndarray
    growth_days: jnp.ndarray
    therapy_days: jnp.ndarray
    post_therapy_days: jnp.ndarray
    simulation_days: jnp.ndarray
    first_therapy_day: jnp.ndarray  # -1 = unset
    first_post_therapy_day: jnp.ndarray
    death_day: jnp.ndarray  # cDeathDay; -1 = alive
    t_benchmark: jnp.ndarray  # -1 = unset
    consecutive_treatment_days: jnp.ndarray = None  # used by TherapyEnv weekends


class BrainTumorEnv(FunctionalEnv):
    def __init__(
        self,
        config: BrainTumorConfig,
        reward,
        ic_sampler: Optional[Callable] = None,
    ):
        self.config = config
        self.reward = reward
        self.ic_sampler = ic_sampler
        self.x_scale = jnp.linspace(0.0, config.X, config.nx)

    @property
    def obs_dim(self) -> int:
        return self.config.nx

    @property
    def action_dim(self) -> int:
        return 1

    # -- helpers -------------------------------------------------------------

    def tumor_radius(self, u, detection_ratio):
        """Rightmost grid point at/above ``ratio·K`` (simulated MRI scan,
        ``brain_tumor_env.py:104-121``). Returns (radius, exists).

        Computed as ``max(where(mask, iota, -1))`` rather than
        ``argmax(mask[::-1])``: the reverse+argmax form lowers to a gather
        while the masked max is a single fused reduction."""
        c = self.config
        mask = u >= detection_ratio * c.k
        iota = jnp.arange(u.shape[0], dtype=jnp.int32)
        idx = jnp.max(jnp.where(mask, iota, -1))
        exists = idx >= 0
        return jnp.where(exists, idx.astype(c.dtype) * c.dx, 0.0), exists

    def _fd_update(self, u, R):
        c = self.config
        dt, dx = c.dtype(c.dt), c.dtype(c.dx)
        u_c, u_l, u_r = u[1:-1], u[:-2], u[2:]
        logistic = u_c * (1.0 - u_c / c.k)
        growth = c.D * (u_r - 2.0 * u_c + u_l) / (dx * dx) + c.rho * logistic
        interior = u_c + dt * (growth - R[1:-1] * logistic)
        nxt = jnp.concatenate([interior[:1], interior, interior[-1:]])
        return jnp.clip(nxt, 0.0, c.k)

    def _radiation_field(self, u_prev, applied_dosage):
        """BED radiation field from the previous day's T2 radius + 25 mm
        margin (``brain_tumor_env.py:247-265``)."""
        c = self.config
        t2, has_t2 = self.tumor_radius(u_prev, c.t2_detection_threshold)
        treatment_radius = jnp.where(has_t2, t2 + 25.0, 0.0)
        d = jnp.where(self.x_scale <= treatment_radius, applied_dosage, 0.0)
        bed = d + d * d / c.alpha_beta_ratio
        R = 1.0 - jnp.exp(-c.alpha * bed)
        return R.astype(c.dtype), treatment_radius

    # -- protocol ------------------------------------------------------------

    def default_ic(self, key):
        """Gaussian seed tumor ``0.8·K·exp(−0.25 x²)``
        (``BrainTumor1DExample.ipynb`` getInitialCondition)."""
        c = self.config
        return (0.8 * c.k * jnp.exp(-0.25 * self.x_scale**2)).astype(c.dtype)

    def init(self, key, t_benchmark=None):
        u0 = self.ic_sampler(key) if self.ic_sampler is not None else self.default_ic(key)
        return self.init_from(u0, t_benchmark)

    def init_from(self, u0, t_benchmark=None):
        c = self.config
        i32 = lambda v: jnp.asarray(v, jnp.int32)
        state = BrainTumorState(
            u=jnp.asarray(u0, c.dtype),
            time_index=i32(0),
            stage=i32(GROWTH),
            remaining_dosage=jnp.asarray(c.total_dosage, c.dtype),
            growth_days=i32(0),
            therapy_days=i32(0),
            post_therapy_days=i32(0),
            simulation_days=i32(0),
            first_therapy_day=i32(-1),
            first_post_therapy_day=i32(-1),
            death_day=i32(-1),
            t_benchmark=i32(-1 if t_benchmark is None else t_benchmark),
            consecutive_treatment_days=i32(0),
        )
        return state, state.u

    def _day_scalars(self, state, t, can, u_new, t1, has_t1, applied,
                     control, treatment_radius):
        """Everything after the field update: stage transitions, day
        bookkeeping, flags, reward routing. Purely elementwise."""
        c = self.config
        is_growth = state.stage == GROWTH
        is_therapy = state.stage == THERAPY
        was_post = state.stage == POST_THERAPY
        remaining = state.remaining_dosage - applied

        # stage transitions (brain_tumor_env.py:147-176)
        to_therapy = jnp.logical_and(
            jnp.logical_and(is_growth, can),
            jnp.logical_and(has_t1, t1 >= c.t1_detection_radius),
        )
        to_post = jnp.logical_and(
            jnp.logical_and(is_therapy, can),
            remaining < c.dosage_termination_threshold,
        )
        stage = jnp.where(to_therapy, THERAPY, jnp.where(to_post, POST_THERAPY, state.stage))

        growth_days = jnp.where(jnp.logical_and(is_growth, can), t, state.growth_days)
        first_therapy_day = jnp.where(to_therapy, t + 1, state.first_therapy_day)
        therapy_days = jnp.where(to_post, t - growth_days, state.therapy_days)
        first_post_therapy_day = jnp.where(to_post, t + 1, state.first_post_therapy_day)

        terminated = t >= c.nt - 1
        truncated = jnp.logical_and(has_t1, t1 >= c.t1_death_radius)
        done = jnp.logical_or(terminated, truncated)

        # day bookkeeping on termination/death, by post-transition stage
        # (brain_tumor_env.py:285-345)
        now_therapy = stage == THERAPY
        now_post = stage == POST_THERAPY
        therapy_days = jnp.where(
            jnp.logical_and(done, now_therapy), t - growth_days, therapy_days
        )
        post_therapy_days = jnp.where(
            jnp.logical_and(done, now_post),
            t - therapy_days - growth_days,
            state.post_therapy_days,
        )
        simulation_days = jnp.where(
            done,
            jnp.where(now_post, growth_days + therapy_days + post_therapy_days,
                      jnp.where(now_therapy, growth_days + therapy_days,
                                state.simulation_days)),
            state.simulation_days,
        )
        death_day = jnp.where(
            jnp.logical_and(truncated, state.death_day < 0), t, state.death_day
        )

        ctx = RewardCtx(
            u=u_new,
            time_index=t,
            executed=jnp.asarray(1, jnp.int32),
            terminated=terminated,
            truncated=truncated,
            action=control,
            norms=jnp.zeros((1,), c.dtype),
            bsum=jnp.zeros((), c.dtype),
            ring=1,
            extras={
                "t_benchmark": state.t_benchmark,
                "treatment_radius": treatment_radius,
                "applied_dosage": applied,
                "total_dosage": jnp.asarray(c.total_dosage, c.dtype),
                "tumor_radius": t1,
            },
        )
        full_reward = self.reward(ctx)
        # reward routing (brain_tumor_env.py:143, 179-218): Therapy steps get
        # the reward every step; Post-Therapy only on episode end; Growth 0.
        reward = jnp.where(
            is_therapy,
            full_reward,
            jnp.where(jnp.logical_and(was_post, done), full_reward, 0.0),
        )

        new_state = state.replace(
            u=u_new,
            time_index=t,
            stage=stage,
            remaining_dosage=remaining,
            growth_days=growth_days,
            therapy_days=therapy_days,
            post_therapy_days=post_therapy_days,
            simulation_days=simulation_days,
            first_therapy_day=first_therapy_day,
            first_post_therapy_day=first_post_therapy_day,
            death_day=death_day,
        )
        return new_state, StepOut(
            obs=u_new,
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info={"stage": stage},
        )

    def step(self, state: BrainTumorState, action, key=None):
        c = self.config
        can = state.time_index < c.nt - 1
        t = jnp.where(can, state.time_index + 1, state.time_index)
        curr = state.u

        is_therapy = state.stage == THERAPY
        # NOT clipped to the [0,1] action box — the reference applies raw
        # control (brain_tumor_env.py:158-159); the min() against remaining
        # dosage is the only cap
        control = jnp.asarray(action, c.dtype).reshape(())
        applied = jnp.where(
            is_therapy,
            jnp.minimum(control * c.total_dosage, state.remaining_dosage),
            c.dtype(0.0),
        )
        R, treatment_radius = self._radiation_field(curr, applied)
        R = jnp.where(is_therapy, R, jnp.zeros_like(R))

        u_new = jnp.where(can, self._fd_update(curr, R), curr)
        t1, has_t1 = self.tumor_radius(u_new, c.t1_detection_threshold)
        return self._day_scalars(
            state, t, can, u_new, t1, has_t1, applied, control,
            treatment_radius,
        )

    # -- batched protocol -----------------------------------------------------

    def observe_batch(self, state: BrainTumorState):
        """Observation is the density row itself — pure function of state,
        so batched rollouts may carry state only (parallel/rollout)."""
        return state.u

    def step_batch(self, state: BrainTumorState, actions):
        """Batched step: ``vmap`` over :meth:`step`. XLA fuses the day body
        into about one pass over the field (docs/PERFORMANCE.md)."""
        return jax.vmap(lambda s, a: self.step(s, a))(state, actions)


class TherapyEnv(FunctionalEnv):
    """Functional counterpart of the reference ``TherapyWrapper``
    (``brain_tumor_env.py:386-506``): hides Growth inside ``init`` and
    Post-Therapy inside ``step``; optional forced weekends."""

    def __init__(self, env: BrainTumorEnv, weekends: bool = False,
                 t_benchmark: Optional[int] = None):
        self.env = env
        self.weekends = weekends
        # baked baseline survival so autoreset episodes carry it (compute once
        # via .benchmark(), like the reference's explicit benchmark() call)
        self.t_benchmark = t_benchmark

    @property
    def config(self):
        return self.env.config

    @property
    def obs_dim(self):
        return self.env.obs_dim

    @property
    def action_dim(self):
        return 1

    def _fast_forward(self, state, stop_in_stage):
        """Zero-action steps until the env leaves ``stop_in_stage`` or ends."""

        def cond(carry):
            state, out = carry
            done = jnp.logical_or(out.terminated, out.truncated)
            return jnp.logical_and(state.stage == stop_in_stage, ~done)

        def body(carry):
            state, _ = carry
            return self.env.step(state, jnp.zeros(()))

        state0, out0 = self.env.step(state, jnp.zeros(()))
        # while-loop from the first step's result (the reference always steps
        # at least once inside its while loops)
        return jax.lax.while_loop(cond, body, (state0, out0))

    def init(self, key, t_benchmark=None):
        if t_benchmark is None:
            t_benchmark = self.t_benchmark
        state, _ = self.env.init(key, t_benchmark)
        state, out = self._fast_forward(state, GROWTH)
        return state, out.obs

    def step(self, state, action, key=None):
        post = state.stage == POST_THERAPY

        # Case 1: fast-forward the rest of life (reference step case 1)
        ff_state, ff_out = self._fast_forward(state, POST_THERAPY)

        # Case 2: one therapy step
        one_state, one_out = self.env.step(state, action)
        if self.weekends:
            # counter update then forced 2-day break after 5 consecutive
            # treatment days; the break steps' outputs are discarded exactly
            # like the reference's `_ = self.env.step(0)` (:460-473)
            control = jnp.asarray(action).reshape(())
            ctd = jnp.where(control > 0, state.consecutive_treatment_days + 1, 0)
            due = ctd >= 5
            ctd = jnp.where(due, 0, ctd)
            wk_state = one_state
            for _ in range(2):
                stepped, _ = self.env.step(wk_state, jnp.zeros(()))
                wk_state = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(due, a, b), stepped, wk_state
                )
            one_state = wk_state.replace(consecutive_treatment_days=ctd)

        sel = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(post, x, y), a, b
        )
        return sel(ff_state, one_state), sel(ff_out, one_out)

    # -- batched protocol -----------------------------------------------------
    # vmap-based: ``vmap`` over the XLA ``lax.while_loop`` gives
    # masked-lockstep fast-forward semantics.

    # TherapyEnv init fast-forwards the whole Growth stage — always gate
    # batched autoresets behind "any env actually ended" regardless of the
    # state-size heuristic (parallel/rollout honors this attr)
    autoreset_gate = True

    def observe_batch(self, state):
        return state.u

    def init_batch(self, keys):
        return jax.vmap(lambda k: TherapyEnv.init(self, k))(keys)

    def step_batch(self, state, actions):
        return jax.vmap(
            lambda s, a: TherapyEnv.step(self, s, a)
        )(state, actions)

    def benchmark(self, key):
        """Zero-treatment episode → baseline survival ``t_benchmark``
        (``brain_tumor_env.py:480-505``)."""
        state, _ = self.env.init(key)

        def cond(carry):
            state, out = carry
            return ~jnp.logical_or(out.terminated, out.truncated)

        def body(carry):
            state, _ = carry
            return self.env.step(state, jnp.zeros(()))

        first = self.env.step(state, jnp.zeros(()))
        final_state, _ = jax.lax.while_loop(cond, body, first)
        return final_state.simulation_days


class DoseTherapyEnv(TherapyEnv):
    """MLP-friendly therapy surface: maps the policy's [-1, 1] action onto a
    dose fraction in [0, 1] and normalizes observed densities by the
    carrying capacity. The training surface of the PPO/SAC examples
    (``examples/train_{ppo,sac}_brain_tumor.py``) and the
    committed-checkpoint tests."""

    def init(self, key, t_benchmark=None):
        state, obs = super().init(key, t_benchmark)
        return state, obs / self.config.k

    def step(self, state, action, key=None):
        dose = jnp.clip((jnp.asarray(action) + 1.0) / 2.0, 0.0, 1.0)
        state, out = super().step(state, dose, key)
        return state, out.replace(obs=out.obs / self.config.k)

    def init_batch(self, keys):
        state, obs = super().init_batch(keys)
        return state, obs / self.config.k

    def step_batch(self, state, action):
        dose = jnp.clip((jnp.asarray(action) + 1.0) / 2.0, 0.0, 1.0)
        state, out = super().step_batch(state, dose)
        return state, out.replace(obs=out.obs / self.config.k)

    def observe_batch(self, state):
        # MUST shadow TherapyEnv's raw-density observe_batch: the rollout's
        # state-only-carry path feeds the policy observe(state), which has
        # to match this env's normalized obs contract (review finding)
        return state.u / self.config.k
