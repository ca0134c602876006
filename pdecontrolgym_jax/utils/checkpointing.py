"""Checkpoint / resume: full training state via orbax, policy parameters as
msgpack via ``flax.serialization``. Both packages are optional (the
``checkpoint`` extra); each function imports what it needs when called.

The reference delegates checkpointing entirely to SB3's CheckpointCallback
(model zips every 10k steps, ``transport1Dppo.py:80-86``); env state is never
saved. Here the whole training state — learner params, optimizer state, AND
the batched env-state pytree — is one pytree, so a checkpoint captures the
exact resume point of the lockstep simulation.
"""

from __future__ import annotations

import os
from typing import Any

import jax


def _require(module: str, extra: str = "checkpoint"):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{module} is needed for checkpoint I/O; install it (the "
            f"'{extra}' extra of pdecontrolgym-jax)"
        ) from e


def save(path: str, tree: Any) -> None:
    """Save any pytree (e.g. a PPO Runner / SACRunner) to ``path``."""
    path = os.path.abspath(path)
    ckptr = _require("orbax.checkpoint").StandardCheckpointer()
    ckptr.save(path, jax.device_get(tree), force=True)
    ckptr.wait_until_finished()


def restore(path: str, template: Any) -> Any:
    """Restore a pytree saved by :func:`save`; ``template`` supplies the
    structure/shapes (e.g. a freshly built runner)."""
    path = os.path.abspath(path)
    ckptr = _require("orbax.checkpoint").StandardCheckpointer()
    return ckptr.restore(path, jax.device_get(template))


def save_params(path: str, params: Any) -> None:
    """Save a (small) parameter pytree as a single msgpack file — the
    policy-only artifact the walkthrough notebooks restore (full training
    state goes through :func:`save`; a SAC runner's replay buffer is far too
    large to commit)."""
    serialization = _require("flax.serialization")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(jax.device_get(params)))


def load_params(path: str, template: Any) -> Any:
    """Restore a pytree saved by :func:`save_params`. ``template`` supplies
    structure/shapes (e.g. ``trainer.init(key).params``)."""
    serialization = _require("flax.serialization")
    with open(path, "rb") as f:
        return serialization.from_bytes(jax.device_get(template), f.read())
