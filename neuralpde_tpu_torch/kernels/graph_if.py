"""IF nodes of a CUDA graph under PyTorch's stream capture.

`if_body(flag, pool)` is a context manager for use while a CUDA graph is
being captured on the current stream: it adds an IF node on the device
flag ``flag`` (a one-element bool tensor) to the graph and captures the
``with`` body into the node's body graph, on a stream of its own
(`body_stream`) that is current inside the ``with``; at replay the body
runs only when the flag is set.  Memory allocated inside the body comes
from ``pool`` (a `BodyPool`, a private pool of the caching allocator that
lives as long as the graph), so the replayed body finds it at the
addresses of its capture.  The node and the capture of its body are made
by `csrc/graph_if.cu` through the CUDA runtime: torch 2.11, which the port
runs on the card, has no IF nodes of its own (later releases add
`CUDAGraph.begin_capture_to_if_node`).

`body_stream(device)` is the one body stream of a device: run eagerly, the
same body runs on it too, so that the libraries it calls (cuBLAS's
workspace of a stream) are set up before any capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ._build import check, load_library

_BODY_STREAMS: dict = {}


@functools.cache
def _launchers() -> ctypes.CDLL:
    lib = load_library()
    lib.graph_if_begin.argtypes = [ctypes.c_void_p] * 3
    lib.graph_if_begin.restype = ctypes.c_int
    lib.graph_if_end.argtypes = [ctypes.c_void_p]
    lib.graph_if_end.restype = ctypes.c_int
    return lib


def body_stream(device) -> torch.cuda.Stream:
    """The stream that IF bodies of ``device`` run on (one a device, kept
    for the process, as `train._side_stream`'s)."""
    device = torch.device(device)
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _BODY_STREAMS:
        _BODY_STREAMS[index] = torch.cuda.Stream(device=index)
    return _BODY_STREAMS[index]


class BodyPool:
    """A private pool of the caching allocator for the IF bodies of one
    captured graph (a pool can take only one capture at a time, and the
    graph's own is taking the graph's).  `release` gives it back; call it
    when the graph is gone."""

    def __init__(self, device):
        device = torch.device(device)
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        self.id = torch.cuda.graph_pool_handle()
        self.uses = 0     # each capture into the pool holds it once

    def begin(self) -> None:
        """Send the allocations made on the current stream, by any thread,
        to the pool."""
        torch._C._cuda_beginAllocateCurrentStreamToPool(self.index, self.id)
        self.uses += 1

    def end(self) -> None:
        torch._C._cuda_endAllocateToPool(self.index, self.id)

    def release(self) -> None:
        for _ in range(self.uses):
            torch._C._cuda_releasePool(self.index, self.id)
        self.uses = 0


@contextlib.contextmanager
def if_body(flag: torch.Tensor, pool):
    """Capture the ``with`` body as an IF node on ``flag`` (module note)."""
    if not (flag.is_cuda and flag.dtype == torch.bool and flag.numel() == 1):
        raise ValueError("if_body: the flag is one bool on a CUDA device")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("if_body: no CUDA graph is being captured on the "
                           "current stream")
    lib = _launchers()
    device = flag.device
    outer = torch.cuda.current_stream(device)
    body = body_stream(device)
    check(lib, lib.graph_if_begin(outer.cuda_stream, flag.data_ptr(),
                                  body.cuda_stream), "IF node")
    try:
        with torch.cuda.stream(body):
            pool.begin()
            try:
                yield
            finally:
                pool.end()
    finally:
        check(lib, lib.graph_if_end(body.cuda_stream), "IF node body")
