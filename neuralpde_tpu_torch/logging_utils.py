"""Logging hook protocol (the counterpart of `neuralpde_tpu.logging_utils`).

`logscalar`/`logvector` dispatch on the logger object: any logger exposing
`log_scalar(name, value, step)` works.  Loggers are called from the host
training loop every `log_frequency` iterations.
"""

from __future__ import annotations


class LogOptions:
    def __init__(self, log_frequency: int = 50):
        self.log_frequency = log_frequency


def logscalar(logger, value, name: str, step: int) -> None:
    if logger is None:
        return
    fn = getattr(logger, "log_scalar", None)
    if fn is not None:
        fn(name, float(value), int(step))


def logvector(logger, values, name: str, step: int) -> None:
    if logger is None:
        return
    for i, v in enumerate(values):
        logscalar(logger, v, f"{name}/{i + 1}", step)
