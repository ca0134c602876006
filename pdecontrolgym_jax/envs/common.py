"""Shared machinery for the 1D boundary-controlled envs (transport, reaction-
diffusion, Burgers).

The reference's 1D envs share an identical shape (``hyperbolic.py:126-169``,
``parabolic.py:126-164``): each agent action is zero-order-held for
``control_sample_rate/dt`` PDE sub-steps, the episode terminates at ``nt-1``
rows and truncates when the L2 norm exceeds ``max_state_value``. Here that hot
sub-step loop is a ``lax.scan`` over a pure row update supplied by each env,
with episode ends masked (frozen state) so batches of envs run in lockstep.

Per-sub-step L2 norms and the running boundary |u[t,-1]| sum are accumulated
inside the scan — these are the O(1) statistics that replace the reference's
full-history reward indexing (see ``rewards/tuned.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.core import pytree
from pdecontrolgym_jax.core.base import FunctionalEnv, RewardCtx, StepOut, roll_ring
from pdecontrolgym_jax.core.sensing import make_control_fn, make_sensing_fn


@dataclasses.dataclass(frozen=True)
class Boundary1DConfig:
    """Static configuration shared by the 1D boundary-control envs.

    Parameter names match the reference kwargs API (``base_env_1d.py:20``,
    ``hyperbolic.py:25-35``) so users can port configs verbatim.
    """

    T: float = 5.0
    dt: float = 1e-4
    X: float = 1.0
    dx: float = 1e-2
    sensing_loc: str = "full"
    control_type: str = "Dirchilet"
    sensing_type: str = "Dirchilet"
    limit_pde_state_size: bool = False
    max_state_value: float = 1e10
    max_control_value: float = 20.0
    control_sample_rate: float = 0.1
    normalize: bool = False
    dtype: Any = jnp.float32
    # "xla" (lax.scan), "pallas" (the interval kernel, ops/pallas1d, GPU
    # only), "interpret" (that kernel in the Pallas interpreter, for tests
    # on the CPU) or "auto" (ops/backend.use_kernel: the kernel on the GPU
    # where it beat XLA, XLA elsewhere)
    backend: str = "auto"
    scan_unroll: int = 8
    # Divergence masking (SURVEY §5 failure detection): a non-finite state
    # truncates the episode instead of silently propagating NaNs through the
    # lockstep batch. Off by default for reference parity (NumPy comparisons
    # with NaN are False, so the reference keeps stepping).
    truncate_on_nonfinite: bool = False

    @property
    def nt(self) -> int:
        # base_env_1d.py:23
        return int(round(self.T / self.dt) + 1)

    @property
    def nx(self) -> int:
        # base_env_1d.py:24
        return int(round(self.X / self.dx))

    @property
    def sample_rate(self) -> int:
        # hyperbolic.py:137
        return int(round(self.control_sample_rate / self.dt))


@pytree.dataclass
class Boundary1DState:
    u: jnp.ndarray  # (state_dim,) current PDE row
    beta: jnp.ndarray  # (state_dim,) plant parameter for this episode
    time_index: jnp.ndarray  # int32 scalar, current row index
    norm_ring: jnp.ndarray  # (ring,) trailing per-row L2 norms
    bsum: jnp.ndarray  # running sum of |u[t, -1]|
    prev_u: Optional[jnp.ndarray] = None  # previous row (only if reward needs it)
    aux_ring: Optional[jnp.ndarray] = None  # (ring,) norms in reward.ring_ord


class Boundary1DEnv(FunctionalEnv):
    """Functional base for the 1D boundary-control family.

    Subclasses define:

    - ``state_dim``: length of the PDE row (nx, or nx+1 with a ghost point).
    - ``_advance(u_prev, boundary_fn, control) -> (u_new, boundary_value)``:
      one explicit sub-step, including the boundary write ordering quirks of
      the scheme being mirrored.
    - ``default_ic(key) -> (u0, beta)``: episode initial condition sampler.
    """

    def __init__(
        self,
        config: Boundary1DConfig,
        reward,
        ic_sampler: Optional[Callable] = None,
        noise_fn: Optional[Callable] = None,
    ):
        self.config = config
        self.reward = reward
        self.ic_sampler = ic_sampler
        self.noise_fn = noise_fn
        # trailing-norm window: wide enough for the largest lag the reward
        # declares, +1 for the current row. Norms are only computed for the
        # last `window` sub-steps of each control interval — the full-rate
        # cross-lane reduction would otherwise dominate the stencil cost.
        self.window = max(int(getattr(reward, "ring_requirement", 1)), 1) + 1
        self._needs_prev = bool(getattr(reward, "needs_prev_row", False))
        # rewards may declare lag reads in a norm other than L2 (NormReward
        # t-horizon with norm="1"/"inf"); the env then carries a SECOND
        # trailing window in that ord alongside the L2 one (truncation always
        # reads L2, hyperbolic.py:182-194)
        self._aux_ord = str(getattr(reward, "ring_ord", "2"))
        self._needs_aux = self._aux_ord != "2"
        self._control_fn = make_control_fn(
            config.control_type, config.normalize, config.max_control_value, config.dx
        )
        self._sensing_fn, self._obs_dim = make_sensing_fn(
            config.sensing_loc,
            config.control_type,
            config.sensing_type,
            config.dx,
            left_dirichlet_fixed_zero=self.left_dirichlet_fixed_zero,
        )

    # -- subclass surface ----------------------------------------------------

    left_dirichlet_fixed_zero: bool = False

    @property
    def state_dim(self) -> int:
        return self.config.nx

    def _advance(self, u_prev, beta, control):
        raise NotImplementedError

    def default_ic(self, key):
        raise NotImplementedError

    # -- protocol ------------------------------------------------------------

    @property
    def obs_dim(self) -> int:
        return self.state_dim if self._obs_dim == -1 else self._obs_dim

    @property
    def action_dim(self) -> int:
        return 1

    def init(self, key):
        if self.ic_sampler is not None:
            u0, beta = self.ic_sampler(key)
        else:
            u0, beta = self.default_ic(key)
        return self.init_from(u0, beta)

    def init_from(self, u0, beta):
        """Build state from explicit initial condition + plant parameter
        (mirrors ``hyperbolic.py:207-219`` where user callables supply both)."""
        c = self.config
        u0 = jnp.asarray(u0, c.dtype)
        beta = jnp.asarray(beta, c.dtype)
        n0 = jnp.linalg.norm(u0)
        # ring semantics at reset: entries before row 0 are ZERO, matching the
        # reference's negative-index wrap into its preallocated zero history
        # (uVec[t-100] with t<100 reads unwritten all-zero rows,
        # tuned_reward_1d.py:40) — only the last slot holds ||u0||
        state = Boundary1DState(
            u=u0,
            beta=beta,
            time_index=jnp.asarray(0, jnp.int32),
            norm_ring=jnp.zeros((self.window,), c.dtype).at[-1].set(n0),
            bsum=jnp.abs(u0[-1]).astype(c.dtype),
            prev_u=u0 if self._needs_prev else None,
            aux_ring=(
                jnp.zeros((self.window,), c.dtype).at[-1].set(self._aux_norm(u0))
                if self._needs_aux else None
            ),
        )
        return state, self._observe(state, key=None)

    def _aux_norm(self, u):
        if self._aux_ord == "1":
            return jnp.sum(jnp.abs(u), axis=-1)
        return jnp.max(jnp.abs(u), axis=-1)  # "inf"

    def _observe(self, state, key):
        obs = self._sensing_fn(state.u)
        if self.noise_fn is not None and key is not None:
            obs = self.noise_fn(obs, key)
        return obs

    def step(self, state, action, key=None):
        c = self.config
        S = c.sample_rate
        W = self.window
        nt = c.nt
        control = jnp.asarray(action, c.dtype).reshape(())

        # prev_u must be the row one SUB-step before the final row
        # (NormReward differential indexes uVec[time_index-1], a sub-step row).
        prev0 = state.prev_u if self._needs_prev else state.u[:0]

        def make_substep(with_norm):
            def substep(carry, _):
                u, up, t, bsum = carry
                active = t < nt - 1
                u_new, boundary = self._advance(u, state.beta, control)
                u_new = jnp.where(active, u_new, u)
                if self._needs_prev:
                    up = jnp.where(active, u, up)
                t = jnp.where(active, t + 1, t)
                bsum = jnp.where(active, bsum + jnp.abs(boundary), bsum)
                out = None
                if with_norm:
                    out = jnp.linalg.norm(u_new)
                    if self._needs_aux:
                        out = (out, self._aux_norm(u_new))
                return (u_new, up, t, bsum), out

            return substep

        # Norms (a cross-lane reduction each) are computed only where a reward
        # can read them: at the reward's declared lag positions when known
        # (often just 1-2 sub-steps per interval), else for the whole trailing
        # window of min(W, S) sub-steps. Exact for every fully-executed
        # interval; on a partial (terminal) interval only lookback entries the
        # terminal reward never reads can go stale (the current-row norm stays
        # exact because frozen sub-steps recompute the unchanged row's norm).
        carry = (state.u, prev0, state.time_index, state.bsum)
        positions = self.norm_positions
        aux = jnp.zeros((S,), c.dtype) if self._needs_aux else None
        if positions is not None:
            norms = jnp.zeros((S,), c.dtype)
            start = 0
            for j in positions:
                if j > start:
                    carry, _ = jax.lax.scan(
                        make_substep(False), carry, None, length=j - start,
                        unroll=min(c.scan_unroll, j - start),
                    )
                carry, n = make_substep(True)(carry, None)
                if self._needs_aux:
                    n, a = n
                    aux = aux.at[j].set(a)
                norms = norms.at[j].set(n)
                start = j + 1
            if S > start:
                carry, _ = jax.lax.scan(
                    make_substep(False), carry, None, length=S - start,
                    unroll=min(c.scan_unroll, S - start),
                )
            norms = norms[-min(W, S):]
            if self._needs_aux:
                aux = aux[-min(W, S):]
        else:
            S2 = min(W, S)
            if S > S2:
                carry, _ = jax.lax.scan(
                    make_substep(False), carry, None, length=S - S2,
                    unroll=min(c.scan_unroll, S - S2),
                )
            carry, norms = jax.lax.scan(
                make_substep(True), carry, None, length=S2,
                unroll=min(c.scan_unroll, S2),
            )
            if self._needs_aux:
                norms, aux = norms
        u, prev_u, t, bsum = carry
        trailing = self._trailing(state.norm_ring, norms)
        aux_trailing = (
            self._trailing(state.aux_ring, aux) if self._needs_aux else None
        )
        return self._finish(state, u, prev_u, t, bsum, trailing, key,
                            aux_trailing)

    def _trailing(self, ring, norms):
        """Advance the trailing-norm window by one full interval: a STATIC
        splice of the carried window and this interval's norms. A per-env
        dynamic slice at `executed` would keep the window aligned on partial
        (terminal) intervals too, but vmapped dynamic slices lower to a
        per-env gather. The window is
        laid out assuming a full interval and read with static end-relative
        indices: exact on every full interval (all reference configs divide
        the horizon); on a partial terminal interval the current-row norm is
        still exact (frozen sub-steps re-evaluate the unchanged row into the
        final slot) while historical lag reads return the frozen norm — see
        RewardCtx.norm_at_lag."""
        S, W = self.config.sample_rate, self.window
        if norms.shape[-1] >= W:
            return norms[..., -W:]
        return jnp.concatenate(
            [ring[..., -(W - norms.shape[-1]):], norms], axis=-1
        )

    def step_with_history(self, state, action, key=None):
        """Like :meth:`step`, additionally returning every sub-step row
        ``(S, state_dim)`` of the interval. Used by the Gymnasium adapter to
        maintain the reference-style full history buffer for legacy reward
        objects; not a hot path."""
        c = self.config
        S, nt = c.sample_rate, c.nt
        control = jnp.asarray(action, c.dtype).reshape(())
        prev0 = state.prev_u if self._needs_prev else state.u[:0]

        def substep(carry, _):
            u, up, t, bsum = carry
            active = t < nt - 1
            u_new, boundary = self._advance(u, state.beta, control)
            u_new = jnp.where(active, u_new, u)
            if self._needs_prev:
                up = jnp.where(active, u, up)
            t = jnp.where(active, t + 1, t)
            bsum = jnp.where(active, bsum + jnp.abs(boundary), bsum)
            aux = self._aux_norm(u_new) if self._needs_aux else jnp.zeros((), u.dtype)
            return (u_new, up, t, bsum), (u_new, jnp.linalg.norm(u_new), aux)

        (u, prev_u, t, bsum), (rows, norms, auxs) = jax.lax.scan(
            substep, (state.u, prev0, state.time_index, state.bsum), None, length=S
        )
        executed = t - state.time_index

        def _trail(ring, vals):
            if S > self.window:
                return vals[-self.window:]
            return roll_ring(ring, vals, executed)

        trailing = _trail(state.norm_ring, norms)
        aux_trailing = _trail(state.aux_ring, auxs) if self._needs_aux else None
        new_state, out = self._finish(state, u, prev_u, t, bsum, trailing, key,
                                      aux_trailing)
        return new_state, out, rows

    @property
    def norm_positions(self):
        """Static sub-step offsets (within a full interval) at which per-row
        norms must be evaluated, derived from the reward's ``required_lags``;
        None = every sub-step in the trailing window. A lag L read at the end
        of a full interval lands on offset ``(S-1-L) mod S`` of some interval,
        and the trailing ring shifts by exactly S per step, so these offset
        classes are invariant."""
        lags = getattr(self.reward, "required_lags", None)
        if lags is None:
            return None
        S = self.config.sample_rate
        J = {(S - 1 - (int(L) % S)) % S for L in lags}
        J.add(S - 1)
        return tuple(sorted(J))

    # -- interval kernel path -------------------------------------------------

    def _kernel_spec(self):
        """Subclasses return ``(KernelSpec, ctrl_transform)`` for the
        interval kernel (ops/pallas1d), or None when unsupported."""
        return None

    def _kernel_wins(self) -> bool:
        """Whether the interval kernel beat XLA end to end on the GPU for
        this env's configuration (PERF.md); subclasses with a kernel
        override."""
        return False

    def _uses_kernel(self) -> bool:
        from pdecontrolgym_jax.ops.backend import use_kernel

        return (
            not self._needs_prev
            and not self._needs_aux  # the kernel computes L2 norms only
            and use_kernel(self.config.backend, self._kernel_wins())
            and self._kernel_spec() is not None
        )

    def _get_interval_fn(self):
        if not hasattr(self, "_interval_fn"):
            from pdecontrolgym_jax.ops.pallas1d import make_interval_fn
            from pdecontrolgym_jax.ops.backend import interpret_mode

            kspec, self._ctrl_transform = self._kernel_spec()
            c = self.config
            self._interval_fn = make_interval_fn(
                kspec,
                sample_rate=c.sample_rate,
                nt=c.nt,
                state_dim=self.state_dim,
                window=self.window,
                norm_positions=self.norm_positions,
                interpret=interpret_mode(c.backend),
            )
        return self._interval_fn

    def step_batch(self, state, actions, keys=None):
        """Step a whole ``(B, ...)`` batch: the interval kernel where
        ``ops/backend.use_kernel`` picks it and the env supports it, else
        vmap over :meth:`step`."""
        if not self._uses_kernel():
            if keys is None:
                return jax.vmap(lambda s, a: self.step(s, a))(state, actions)
            return jax.vmap(self.step)(state, actions, keys)

        c = self.config
        interval_fn = self._get_interval_fn()
        ctrl = jax.vmap(self._ctrl_transform)(
            jnp.asarray(actions, c.dtype).reshape(-1)
        )[:, None]
        u, norms, bsum_add, t_new = interval_fn(
            state.u, state.beta, ctrl, state.time_index[:, None]
        )
        bsum = state.bsum + bsum_add[:, 0]
        t = t_new[:, 0]
        trailing = self._trailing(state.norm_ring, norms)
        if keys is None:
            return jax.vmap(
                lambda st, uu, tt, bs, nn: self._finish(st, uu, None, tt, bs, nn, None)
            )(state, u, t, bsum, trailing)
        return jax.vmap(
            lambda st, uu, tt, bs, nn, kk: self._finish(st, uu, None, tt, bs, nn, kk)
        )(state, u, t, bsum, trailing, keys)

    # -- shared step tail -----------------------------------------------------

    def _finish(self, state, u, prev_u, t, bsum, trailing, key,
                aux_trailing=None):
        """Shared step tail. ``trailing`` is the trailing-norm window:
        ``trailing[-1]`` = current row's L2 norm, ``trailing[-1-k]`` = k
        sub-steps earlier. ``aux_trailing`` is the same window in the
        reward's declared ``ring_ord`` when that is not L2."""
        c = self.config
        nt = c.nt
        executed = t - state.time_index
        cur_norm = trailing[-1]

        terminated = t >= nt - 1  # hyperbolic.py:171-180
        truncated = jnp.logical_and(  # hyperbolic.py:182-194
            bool(c.limit_pde_state_size), cur_norm >= c.max_state_value
        )
        if c.truncate_on_nonfinite:
            truncated = jnp.logical_or(truncated, ~jnp.isfinite(cur_norm))

        ctx = RewardCtx(
            u=u,
            time_index=t,
            executed=executed,
            terminated=terminated,
            truncated=truncated,
            action=u[-1],
            norms=trailing,
            bsum=bsum,
            ring=self.window,
            extras={"prev_u": prev_u} if self._needs_prev else None,
            aux_norms=aux_trailing,
        )
        reward = self.reward(ctx)

        new_state = state.replace(
            u=u,
            time_index=t,
            norm_ring=trailing,
            bsum=bsum,
            prev_u=prev_u if self._needs_prev else None,
            aux_ring=aux_trailing,
        )
        out = StepOut(
            obs=self._observe(new_state, key),
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info={},
        )
        return new_state, out
