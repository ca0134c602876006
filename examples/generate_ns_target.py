"""Generate a Navier-Stokes tracking target compatible with the reference's
``examples/NavierStokes/target.npz`` (keys ``u``, ``v``, each (nt, nx, ny)).

The reference ships a precomputed lid-driven trajectory; this regenerates an
equivalent one with the engine itself (lid velocity 2.0), so reference scripts
that do ``np.load('target.npz')`` run against our data unmodified.
"""

import argparse

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_jax.rewards.ns import NSReward


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="target.npz")
    ap.add_argument("--lid", type=float, default=2.0)
    args = ap.parse_args()

    from pdecontrolgym_jax.envs.navier_stokes import make_lid_target

    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"],
        "right": ["Dirchilet", "Dirchilet"],
    })
    cfg = NavierStokesConfig(T=0.2, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05,
                             boundary_condition=bc, dtype=jnp.float64)
    U_ref, _ = make_lid_target(cfg, lid=args.lid)
    U = np.asarray(U_ref)
    np.savez(args.out, u=U[..., 0], v=U[..., 1])
    print(f"wrote {args.out}: u/v shape {U[..., 0].shape}, "
          f"final max|u| = {np.abs(U[-1, ..., 0]).max():.3f}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
