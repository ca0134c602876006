"""Spatial sharding: halo-exchange stencils over a mesh axis.

The batch-of-envs axis is this workload's primary parallel dimension (grids
are tiny, SURVEY §5), but for very large grids the sequence-parallel analog is
sharding the SPATIAL axis: each device owns a contiguous slab of the row and
exchanges one-point halos with its neighbors via ``ppermute`` each sub-step
inside ``shard_map``.

Two tiers live here:

- **The public path** — :func:`make_sharded_env` + :func:`env_spatial_mesh`:
  wrap any env family's XLA batched path, pin ``NamedSharding`` constraints
  on the state pytree over a 2D ``(env, x)`` mesh, and let XLA's SPMD
  partitioner insert the halo collectives for the stencils. Two lines, runs
  through the normal ``parallel.rollout`` API (docs/API.md).
- **Explicit-collective references** — hand-wired ``shard_map`` kernels for
  the transport upwind stencil (``make_spatial_transport_interval`` /
  ``make_spatial_transport_episode``) and the 2D NS projection step
  (``make_spatial_ns_step``), exact vs the single-device envs. These show
  the collectives GSPMD inserts implicitly: the upwind update needs each
  slab's RIGHT neighbor's first point; β·u(0,t) needs the global left
  boundary value, broadcast from shard 0 once per sub-step.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

X_AXIS = "x"
from pdecontrolgym_jax.parallel.mesh import ENV_AXIS  # noqa: E402 ("env")


def spatial_mesh(devices=None) -> Mesh:
    import numpy as np

    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (X_AXIS,))


def env_spatial_mesh(spatial_shards: int, devices=None) -> Mesh:
    """2D ``(env, x)`` mesh: the env-batch axis times a spatial axis of
    ``spatial_shards`` devices. The standard mesh for
    :func:`make_sharded_env` — batch parallelism stays the primary axis and
    the grid splits over ``x`` only as far as it must."""
    import numpy as np

    devices = list(devices) if devices is not None else jax.devices()
    if len(devices) % spatial_shards:
        raise ValueError(
            f"{len(devices)} devices do not split into spatial_shards="
            f"{spatial_shards}"
        )
    n_env = len(devices) // spatial_shards
    return Mesh(
        np.array(devices).reshape(n_env, spatial_shards), (ENV_AXIS, X_AXIS)
    )


class SpatialShardedEnv:
    """Batched env wrapper whose state is sharded over a 2D ``(env, x)``
    mesh: the env-batch dimension over ``env`` and the GRID dimension over
    ``x`` — the public path for grids too large for one card
    (docs/API.md "Spatial sharding").

    Rather than hand-writing halo exchanges
    (the ``make_spatial_*`` demos below do that for two families), the
    wrapper pins ``NamedSharding`` constraints on every state leaf and lets
    XLA's SPMD partitioner insert the halo ``collective-permute``s for the
    stencil slices/rolls — so it works for EVERY env family's XLA step path
    unchanged. The per-leaf rule: a trailing ``state_dim`` axis (1D fields,
    β) or a ``(ny, nx)`` trailing pair (NS fields, sharded over rows) maps
    to ``x``; everything else is sharded over ``env`` only.

    Use through the normal rollout API::

        mesh = env_spatial_mesh(spatial_shards=2)
        senv = make_sharded_env(env, mesh)
        (state, obs), outs = rollout(senv, policy, num_envs, steps, key)

    Constraints: the wrapped env must run its XLA batched path — Pallas
    kernels are opaque to the SPMD partitioner — so build 1D envs with
    ``backend="xla"``; the factory raises otherwise. ``num_envs`` must divide the ``env`` axis and
    the grid the ``x`` axis.
    """

    def __init__(self, env, mesh: Mesh):
        if ENV_AXIS not in mesh.axis_names or X_AXIS not in mesh.axis_names:
            raise ValueError(
                f"mesh must carry ({ENV_AXIS!r}, {X_AXIS!r}) axes, got "
                f"{mesh.axis_names}"
            )
        if getattr(env, "_uses_kernel", lambda: False)():
            raise ValueError(
                "spatial sharding needs backend='xla': pallas_call is "
                "opaque to the SPMD partitioner"
            )
        self.env = env
        self.mesh = mesh
        self._sdim = getattr(env, "state_dim", None)
        cfg = getattr(env, "config", None)
        self._grid2d = (
            (cfg.ny, cfg.nx)
            if cfg is not None and hasattr(cfg, "ny") and hasattr(cfg, "nx")
            else None
        )

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _spec(self, leaf) -> P:
        # batched leaf (B, ...): spatial trailing dims -> x, batch -> env
        if (self._grid2d is not None and leaf.ndim >= 3
                and tuple(leaf.shape[-2:]) == self._grid2d):
            return P(ENV_AXIS, *([None] * (leaf.ndim - 3)), X_AXIS, None)
        if (self._sdim is not None and leaf.ndim >= 2
                and leaf.shape[-1] == self._sdim):
            return P(ENV_AXIS, *([None] * (leaf.ndim - 2)), X_AXIS)
        return P(ENV_AXIS, *([None] * (leaf.ndim - 1)))

    def constrain(self, state):
        """Pin the batched state pytree's shardings (used inside jit; on
        concrete arrays it places them on the mesh)."""
        return jax.tree_util.tree_map(
            lambda l: jax.lax.with_sharding_constraint(
                l, NamedSharding(self.mesh, self._spec(l))
            ),
            state,
        )

    # rollout/batch_step talk to init (per-env, vmapped) and step_batch
    def init(self, key):
        return self.env.init(key)

    def step(self, state, action, key=None):
        return self.env.step(state, action, key)

    def step_batch(self, state, actions, keys=None):
        state = self.constrain(state)
        if keys is None:
            new_state, out = self.env.step_batch(state, actions)
        else:
            new_state, out = self.env.step_batch(state, actions, keys)
        return self.constrain(new_state), out


def make_sharded_env(env, mesh: Mesh) -> SpatialShardedEnv:
    """Two-line public path to spatially sharded rollouts — see
    :class:`SpatialShardedEnv`."""
    return SpatialShardedEnv(env, mesh)


def make_spatial_transport_interval(mesh: Mesh, dt: float, dx: float,
                                    sample_rate: int):
    """Returns jitted ``fn(u, beta, control) -> u_final`` with ``u``/``beta``
    sharded over the spatial mesh axis. Matches
    ``TransportEnv._advance`` semantics (boundary column = control, constant
    over the interval)."""
    n_shards = mesh.size

    def interval(u_local, beta_local, control):
        axis_idx = jax.lax.axis_index(X_AXIS)
        is_last = axis_idx == n_shards - 1
        right_neighbor = [(i, (i - 1) % n_shards) for i in range(n_shards)]

        def substep(u, _):
            # halo: receive the RIGHT neighbor's first point (shifted left)
            head = u[:1]
            halo = jax.lax.ppermute(head, X_AXIS, right_neighbor)
            up = jnp.concatenate([u[1:], halo])
            # global u(0,t): every shard needs slab 0's head
            heads = jax.lax.all_gather(head, X_AXIS)
            u0 = heads[0, 0]
            interior = u + dt * ((up - u) / dx + u0 * beta_local)
            # last shard's last column is the controlled boundary
            col = jnp.arange(u.shape[0])
            u_new = jnp.where(
                jnp.logical_and(is_last, col == u.shape[0] - 1),
                control,
                interior,
            )
            return u_new, None

        u_final, _ = jax.lax.scan(substep, u_local, None, length=sample_rate)
        return u_final

    sharded = jax.shard_map(
        interval,
        mesh=mesh,
        in_specs=(P(X_AXIS), P(X_AXIS), P()),
        out_specs=P(X_AXIS),
    )
    return jax.jit(sharded)


def make_spatial_transport_episode(mesh: Mesh, *, dt: float, dx: float,
                                   sample_rate: int, nt: int,
                                   terminate_reward: float = 3e2,
                                   lookback: int = 100):
    """Full closed-loop backstepping episode on a SPATIALLY sharded transport
    state: one PDE too large for a single device, split over the ``x`` mesh
    axis with one-point ``ppermute`` halos per sub-step — the full-episode
    upgrade of :func:`make_spatial_transport_interval`.

    Returns jitted ``fn(u, beta, kernel) -> (rewards, u_final)`` where all
    three inputs are ``(nx,)`` arrays sharded over ``x``:

    - the backstepping control is computed distributively each interval:
      ``ctrl = psum(kern_local · u_local) · dx`` (a sharded dot product);
    - rewards reproduce ``TunedReward1D`` exactly (envs/common.py step
      semantics): running ``‖u(t−lookback)‖ − ‖u(t)‖`` per interval and the
      terminal ``terminate_reward − bsum/1000 − ‖u(T)‖`` bonus gated on
      ``‖u(T)‖ < 20``, with norms as ``sqrt(psum(local Σu²))`` — verified
      against ``TransportEnv`` to fp tolerance in
      ``tests/test_spatial_sharding.py``;
    - requires ``(nt−1) % sample_rate == 0`` (every reference config: the
      horizon divides into full control intervals) and ``lookback <
      sample_rate``.
    """
    S = sample_rate
    if (nt - 1) % S:
        raise ValueError("horizon must divide into full control intervals")
    if not 0 < lookback < S:
        raise ValueError("lookback must be inside one control interval")
    n_steps = (nt - 1) // S
    n_shards = mesh.size
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def episode(u_local, beta_local, kern_local):
        axis_idx = jax.lax.axis_index(X_AXIS)
        is_last = axis_idx == n_shards - 1
        col = jnp.arange(u_local.shape[0])
        last_col = jnp.logical_and(is_last, col == u_local.shape[0] - 1)

        def norm(u):
            return jnp.sqrt(jax.lax.psum(jnp.sum(u * u), X_AXIS))

        def make_sub(ctrl):
            def sub(u, _):
                # halo: the RIGHT neighbor's first point; the wrap into the
                # last shard is dead (its last column is the boundary write)
                halo = jax.lax.ppermute(u[:1], X_AXIS, perm)
                up = jnp.concatenate([u[1:], halo])
                # recirculation reads the OLD global u(0, t) (shard 0's head)
                u0 = jax.lax.all_gather(u[:1], X_AXIS)[0, 0]
                un = u + dt * ((up - u) / dx + u0 * beta_local)
                return jnp.where(last_col, ctrl, un), None

            return sub

        def interval(carry, _):
            u, t, bsum = carry
            ctrl = jax.lax.psum(jnp.dot(kern_local, u), X_AXIS) * dx
            sub = make_sub(ctrl)
            # segment the S sub-steps so the two norms the reward reads
            # (lag `lookback` and lag 0 from the interval end) are computed
            # exactly where TunedReward1D reads them
            u, _ = jax.lax.scan(sub, u, None, length=S - lookback)
            prev = norm(u)
            u, _ = jax.lax.scan(sub, u, None, length=lookback)
            cur = norm(u)
            bsum = bsum + S * jnp.abs(ctrl)  # boundary is ctrl all interval
            t = t + S
            terminated = t >= nt - 1
            r_term = terminate_reward - bsum / 1000.0 - cur
            r = jnp.where(jnp.logical_and(terminated, cur < 20.0),
                          r_term, prev - cur)
            return (u, t, bsum), r

        # bsum starts at |u0[-1]| (envs/common.py init_from)
        tails = jax.lax.all_gather(u_local[-1:], X_AXIS)
        bsum0 = jnp.abs(tails[-1, 0])
        (u, _, _), rewards = jax.lax.scan(
            interval, (u_local, jnp.asarray(0, jnp.int32), bsum0), None,
            length=n_steps)
        # rewards are built from psum-reduced scalars so every shard holds
        # the same values, but the scan carry's vma unification marks them
        # device-varying; a psum-mean re-asserts the replication statically
        # (n_steps scalars, once per episode)
        rewards = jax.lax.psum(rewards, X_AXIS) / n_shards
        return rewards, u

    sharded = jax.shard_map(
        episode,
        mesh=mesh,
        in_specs=(P(X_AXIS), P(X_AXIS), P(X_AXIS)),
        out_specs=(P(), P(X_AXIS)),
    )
    return jax.jit(sharded)


def make_spatial_ns_step(mesh: Mesh, *, dx: float, dy: float, dt: float,
                         viscosity: float, density: float, iters: int,
                         boundary_condition, ny: int):
    """2D slab decomposition of the Navier-Stokes projection step — the
    SP-analog extended to 2D fields: each device owns a contiguous slab of
    ROWS (the y axis) and exchanges one-ROW halos with its neighbors via
    ``ppermute`` — before the predictor, before the pressure RHS, once per
    Jacobi sweep, and before the corrector's ∂p/∂y.

    Semantics match ``NavierStokesEnv._advance`` with
    ``pressure_solver="jacobi"`` exactly (same interior-only derivative
    helpers, boundary write order, and sequential Neumann pressure-edge
    copies — exact-match tested in ``tests/test_spatial_sharding.py``). The
    spectral/matpow pressure modes need global transforms and stay
    single-shard; the iterative mode is the one that scales to grids larger
    than a device.

    Returns jitted ``fn(u, v, p, action) -> (u', v', p')`` with all fields
    ``(ny, nx)`` sharded over the row axis. Each slab needs ≥2 rows (the
    global edge shards read their second row for Neumann copies).
    """
    n_shards = mesh.size
    if ny % n_shards:
        raise ValueError(f"ny={ny} must divide over {n_shards} shards")
    if ny // n_shards < 2:
        raise ValueError("each slab needs at least 2 rows")
    k = ny // n_shards
    nu = viscosity
    # send my LAST row to the next shard (it becomes their 'row above') and
    # my FIRST row to the previous shard (their 'row below')
    perm_down = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    perm_up = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def ext(f):
        """(k, nx) slab -> (k+2, nx) with neighbor halo rows. Wrap rows at
        the global edges carry garbage; every consumer masks them out via
        the global-interior row mask."""
        above = jax.lax.ppermute(f[-1:], X_AXIS, perm_down)
        below = jax.lax.ppermute(f[:1], X_AXIS, perm_up)
        return jnp.concatenate([above, f, below])

    def step(u, v, p, action):
        axis_idx = jax.lax.axis_index(X_AXIS)
        grow = axis_idx * k + jnp.arange(k)  # global row index per local row
        col = jnp.arange(u.shape[-1])
        nx = u.shape[-1]
        int_y = jnp.logical_and(grow >= 1, grow <= ny - 2)[:, None]
        int_x = jnp.logical_and(col >= 1, col <= nx - 2)[None, :]
        interior = jnp.logical_and(int_y, int_x)

        def ddx(f):
            out = (jnp.roll(f, -1, axis=-1) - jnp.roll(f, 1, axis=-1)) / (2.0 * dx)
            return jnp.where(interior, out, 0.0)

        def ddy(fe):
            out = (fe[2:] - fe[:-2]) / (2.0 * dy)
            return jnp.where(interior, out, 0.0)

        def lap(fe):
            f = fe[1:-1]
            out = (
                jnp.roll(f, 1, axis=-1) + jnp.roll(f, -1, axis=-1)
                + fe[:-2] + fe[2:] - 4.0 * f
            ) / (dx * dy)
            return jnp.where(interior, out, 0.0)

        def apply_boundary(u, v):
            """Reference edge-write order lower/upper/left/right x (u, v)
            (navier_stokes2D.py:76-91); row edges live on the edge shards."""
            act = jnp.asarray(action).reshape(-1)
            a = act[0] if act.shape[0] == 1 else act
            fields = [u, v]
            edges = ("lower", "upper", "left", "right")
            for pos, conds in zip(edges, boundary_condition):
                for i, cond in enumerate(conds):
                    f = fields[i]
                    if cond == "Neumann":
                        # inner-neighbor rows are local: slabs have >=2 rows
                        if pos == "lower":
                            val = jnp.where(grow[:, None] == 0, f[1:2], f)
                        elif pos == "upper":
                            val = jnp.where(grow[:, None] == ny - 1,
                                            f[k - 2:k - 1], f)
                        elif pos == "left":
                            val = jnp.where(col[None, :] == 0, f[:, 1:2], f)
                        else:
                            val = jnp.where(col[None, :] == nx - 1, f[:, -2:-1], f)
                    else:
                        # both reference spellings of Dirichlet are zero
                        write = a if cond == "Controllable" else 0.0
                        if pos == "lower":
                            val = jnp.where(grow[:, None] == 0, write, f)
                        elif pos == "upper":
                            val = jnp.where(grow[:, None] == ny - 1, write, f)
                        elif pos == "left":
                            val = jnp.where(col[None, :] == 0, write, f)
                        else:
                            val = jnp.where(col[None, :] == nx - 1, write, f)
                    fields[i] = val
            return fields[0], fields[1]

        # --- predictor ---
        ue, ve = ext(u), ext(v)
        u_pred = u + dt * (-u * ddx(u) - v * ddy(ue) + nu * lap(ue))
        v_pred = v + dt * (-u * ddx(v) - v * ddy(ve) + nu * lap(ve))
        u_pred, v_pred = apply_boundary(u_pred, v_pred)

        # --- pressure: fixed-iteration Jacobi with per-sweep halos ---
        upe, vpe = ext(u_pred), ext(v_pred)
        rhs = jnp.where(
            interior,
            density / dt * (
                (jnp.roll(u_pred, -1, -1) - jnp.roll(u_pred, 1, -1)) / (2.0 * dx)
                + (vpe[2:] - vpe[:-2]) / (2.0 * dy)
            ),
            0.0,
        )

        def neumann_edges(pp):
            # reference order: right col, global row 0, left col, global last
            # row — each write reads the PREVIOUS write's result, so the
            # corner chain matches the sequential copies (poisson2d.py)
            pp = jnp.where(col[None, :] == nx - 1, jnp.roll(pp, 1, -1), pp)
            pp = jnp.where(grow[:, None] == 0, pp[1:2], pp)
            pp = jnp.where(col[None, :] == 0, jnp.roll(pp, -1, -1), pp)
            pp = jnp.where(grow[:, None] == ny - 1, pp[k - 2:k - 1], pp)
            return pp

        def sweep(_, pp):
            pe = ext(pp)
            inner = 0.25 * (
                jnp.roll(pp, 1, -1) + jnp.roll(pp, -1, -1)
                + pe[:-2] + pe[2:] - dx * dy * rhs
            )
            pp = jnp.where(interior, inner, pp)
            return neumann_edges(pp)

        p_new = jax.lax.fori_loop(0, iters, sweep, p)

        # --- corrector ---
        pe = ext(p_new)
        u_next = u_pred - dt / density * ddx(p_new)
        v_next = v_pred - dt / density * ddy(pe)
        u_next, v_next = apply_boundary(u_next, v_next)
        return u_next, v_next, p_new

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(X_AXIS), P(X_AXIS), P(X_AXIS), P()),
        out_specs=(P(X_AXIS), P(X_AXIS), P(X_AXIS)),
    )
    return jax.jit(sharded)
