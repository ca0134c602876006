"""Kernel-level numerical debugging: ``checkify`` NaN surfacing + CFL audits.

The production envs handle numerical blow-up by *masked truncation*
(``Boundary1DConfig.truncate_on_nonfinite`` — the lockstep batch keeps
running, the diverged env truncates and autoresets; SURVEY §5 "failure
detection"). That is the right behavior at speed, but it is silent: during
development you want to know *where* a NaN was born. This module provides the
loud path:

- :func:`checked_step` wraps an env's ``step`` in
  ``jax.experimental.checkify`` so a non-finite state surfaces as a Python
  ``JaxRuntimeError`` naming the env, the time index, and the offending
  quantity (instead of NaNs silently flowing through the batch).
- :func:`cfl_report` audits a config *before* you run it: explicit-scheme
  stability numbers (upwind CFL, FTCS Fourier number, diffusion bounds) with
  the exact config fields to change. The reference has no equivalent — its
  only guard is the NS construction-time assert
  (``src/environments2d/navier_stokes2D.py:56-58``); the 1D envs just blow up
  (``hyperbolic.py:182-194`` truncates after the fact).

Debug mode costs a functionalized error carry through the scan — use it to
diagnose, then switch back to the plain step (or ``truncate_on_nonfinite``)
for production.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked_step(env, include_obs: bool = True):
    """Wrap ``env.step`` with finiteness checks on the new PDE state.

    Returns ``step(state, action, key=None) -> (state, out)`` that raises
    ``checkify.JaxRuntimeError`` (after an implicit ``throw``) when the row
    produced by the sub-step scan contains non-finite values. The check runs
    once per *agent* step (not per PDE sub-step), so the overhead is one
    ``isfinite`` reduction per control interval.

    For vmapped use, call :func:`checked_step_batch` instead — ``checkify``
    must wrap *outside* the ``vmap`` so per-env errors aggregate.
    """

    name = type(env).__name__

    def _step(state, action, key=None):
        new_state, out = env.step(state, action, key)
        u = getattr(new_state, "u", None)
        if u is not None:
            checkify.check(
                jnp.all(jnp.isfinite(u)),
                name + ": non-finite PDE state at time_index={t} "
                "(action={a}); the explicit scheme likely violated its "
                "stability bound — run utils.debug.cfl_report(config) "
                "or enable truncate_on_nonfinite for masked handling.",
                t=new_state.time_index,
                a=jnp.asarray(action, jnp.float32).reshape(-1)[0],
            )
        if include_obs:
            checkify.check(
                jnp.all(jnp.isfinite(out.reward)),
                name + ": non-finite reward at time_index={t}",
                t=new_state.time_index,
            )
        return new_state, out

    checked = checkify.checkify(_step)

    def step(state, action, key=None):
        err, result = checked(state, action, key)
        err.throw()
        return result

    return step


def checked_step_batch(env):
    """Batched variant: vmapped step with error aggregation across envs.

    Returns ``step(states, actions) -> (states, outs)``; if *any* env in the
    batch produced a non-finite row, raises with the first failing env's
    message. ``checkify`` wraps outside the ``vmap`` so the error carry is
    reduced over the batch axis (standard checkify-of-vmap semantics).
    """

    name = type(env).__name__

    def _one(state, action):
        new_state, out = env.step(state, action)
        checkify.check(
            jnp.all(jnp.isfinite(new_state.u)),
            name + ": non-finite PDE state at time_index={t}",
            t=new_state.time_index,
        )
        return new_state, out

    checked = checkify.checkify(jax.vmap(_one))

    def step(states, actions):
        err, result = checked(states, actions)
        err.throw()
        return result

    return step


@dataclasses.dataclass
class StabilityFinding:
    quantity: str
    value: float
    bound: float
    ok: bool
    fix: str

    def __str__(self):
        mark = "ok " if self.ok else "VIOLATED"
        return (
            f"[{mark}] {self.quantity} = {self.value:.4g} "
            f"(bound {self.bound:.4g}) — {self.fix}"
        )


def cfl_report(config: Any, verbose: bool = False):
    """Audit explicit-scheme stability numbers for a config dataclass.

    Recognizes the 1D boundary configs (transport CFL ``dt/dx``, FTCS Fourier
    number ``dt/dx²``, Burgers viscous bound) and ``NavierStokesConfig``
    (diffusion bound, the one the reference asserts). Returns a list of
    :class:`StabilityFinding`; raises ``ValueError`` listing every violated
    bound. ``verbose`` prints the full report.
    """
    findings = []
    name = type(config).__name__
    dt = float(config.dt)

    if hasattr(config, "dy"):  # NavierStokesConfig
        dx, dy = float(config.dx), float(config.dy)
        nu = float(config.viscosity)
        # dimensionless diffusion number vs its bound (sf·0.5), so the
        # printed value IS the named quantity
        diff_num = dt * nu / min(dx, dy) ** 2
        bound = float(getattr(config, "stable_factor", 0.5)) * 0.5
        findings.append(StabilityFinding(
            "NS diffusion number dt·ν/min(dx,dy)²", diff_num, bound,
            diff_num <= bound,
            "reduce dt or viscosity (reference guard navier_stokes2D.py:56-58)",
        ))
    elif hasattr(config, "dx"):
        dx = float(config.dx)
        if "Burgers" in name:
            nu = float(getattr(config, "viscosity", 0.0))
            if nu:
                bound = 0.5 * dx * dx / nu
                findings.append(StabilityFinding(
                    "Burgers viscous number dt vs dx²/2ν", dt, bound, dt <= bound,
                    "reduce dt or viscosity",
                ))
            # advective CFL depends on max|u| ≈ max_control_value
            umax = float(getattr(config, "max_control_value", 1.0)) or 1.0
            cfl = dt * umax / dx
            findings.append(StabilityFinding(
                "Burgers advective CFL dt·max|u|/dx", cfl, 1.0, cfl <= 1.0,
                f"assumes max|u|≈{umax}; reduce dt if states exceed it",
            ))
        elif "ReactionDiffusion" in name:
            F = dt / (dx * dx)
            findings.append(StabilityFinding(
                "FTCS Fourier number dt/dx²", F, 0.5, F <= 0.5,
                "reduce dt, or use scheme='implicit' (unconditionally stable "
                "θ-scheme, an extension beyond the reference)",
            ))
        else:  # transport / generic hyperbolic
            cfl = dt / dx
            findings.append(StabilityFinding(
                "upwind CFL dt/dx", cfl, 1.0, cfl <= 1.0,
                "reduce dt or coarsen dx (first-order upwind bound)",
            ))

    if verbose:
        for f in findings:
            print(f)
    bad = [f for f in findings if not f.ok]
    if bad:
        raise ValueError(
            f"{name}: {len(bad)} stability bound(s) violated:\n"
            + "\n".join(str(f) for f in bad)
        )
    return findings
