"""Logging hook protocol (the counterpart of `neuralpde_tpu.logging_utils`;
reference: src/pinn_types.jl:7-46, ext/NeuralPDETensorBoardLoggerExt.jl).

`logscalar`/`logvector` dispatch on the logger object: any logger exposing
`log_scalar(name, value, step)` works; `TensorBoardLogger` writes event
files through tensorboardX when it is installed, and otherwise warns and
does nothing.  Loggers are called from the host training loop every
`log_frequency` iterations.
"""

from __future__ import annotations

import warnings


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


class TensorBoardLogger:
    """TensorBoard backend (tensorboardX): one scalar series per name, as
    the reference's TBLogger extension writes them."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            warnings.warn("tensorboardX not available; TensorBoardLogger is "
                          "a no-op")
            self._writer = None
        else:
            self._writer = SummaryWriter(logdir)

    def log_scalar(self, name: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(name, value, step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
