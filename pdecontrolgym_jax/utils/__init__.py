from pdecontrolgym_jax.utils.checkpointing import (
    load_params,
    restore,
    save,
    save_params,
)
from pdecontrolgym_jax.utils.debug import cfl_report, checked_step, checked_step_batch
from pdecontrolgym_jax.utils.metrics import MetricsLogger
from pdecontrolgym_jax.utils.plotting import ns_fields, spacetime_1d, surface_1d
from pdecontrolgym_jax.utils.profiling import steps_per_second, time_device_fn, trace

__all__ = [
    "MetricsLogger",
    "ns_fields",
    "spacetime_1d",
    "surface_1d",
    "cfl_report",
    "checked_step",
    "checked_step_batch",
    "load_params",
    "restore",
    "save",
    "save_params",
    "steps_per_second",
    "time_device_fn",
    "trace",
]
