"""The one place that decides which backend runs a step.

Hand-written kernels compile for the GPU only (Pallas through Triton). On the
CPU every env runs its XLA path. Any other platform is an error: nothing
here guesses what a new device can compile.
"""

from __future__ import annotations

import jax

BACKENDS = ("auto", "xla", "pallas", "interpret")


def platform() -> str:
    """``"gpu"`` or ``"cpu"``, from ``jax.default_backend()``; raises on any
    other platform."""
    p = jax.default_backend()
    if p not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this engine runs on 'gpu' "
            "(CUDA) or 'cpu'"
        )
    return p


def use_kernel(backend: str, kernel_wins: bool) -> bool:
    """Whether a step with a hand-written kernel should run it.

    ``backend`` is the env's setting: ``"xla"`` never, ``"pallas"`` and
    ``"interpret"`` always (the caller asked for it), ``"auto"`` only on the
    GPU and only where ``kernel_wins`` (the kernel beat XLA end to end on
    the card at the benchmark's shapes, PERF.md).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "xla":
        return False
    if backend in ("pallas", "interpret"):
        return True
    return platform() == "gpu" and kernel_wins


def interpret_mode(backend: str) -> bool:
    """Interpret mode only when the caller asked for it by name. A forced
    ``"pallas"`` off the GPU is refused rather than silently interpreted."""
    if backend == "interpret":
        return True
    if platform() != "gpu":
        raise RuntimeError(
            "backend='pallas' compiles the kernel for the GPU; on the CPU "
            "use backend='xla', or backend='interpret' to run the kernel in "
            "the Pallas interpreter"
        )
    return False
