"""Multi-process initialization (`neuralpde_tpu.parallel.distributed`).

`jax.distributed.initialize` joins the processes of a pod to one
controller; here every process drives one device and joins a
`torch.distributed` process group: NCCL for cards, gloo when the caller
asks for the CPU.  The same sharded training code then runs under
`make_mesh()` over all the group's ranks (`parallel.mesh`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import BATCH_AXIS, make_mesh


def _init_method(address: str) -> str:
    """A torch init method from a coordinator address: ``tcp://...`` and
    ``file://...`` as given, ``host:port`` (the JAX package's form) over
    TCP."""
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device=None) -> None:
    """Join this process to the process group.

    With no arguments, ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) says where and who; otherwise
    ``coordinator_address`` (``host:port``, ``tcp://host:port`` or
    ``file:///path``, the last for processes of one host), ``num_processes``
    and ``process_id``.  ``device`` (default ``cuda:{LOCAL_RANK}``, made the
    current card; a ``"cuda"`` without an index means that card too) picks
    the backend: NCCL for a card, gloo for ``"cpu"``."""
    if device is None or torch.device(device) == torch.device("cuda"):
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        kwargs = dict(init_method=_init_method(coordinator_address),
                      world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend, **kwargs)


def global_batch_mesh(axis_name: str = BATCH_AXIS, device=None):
    """Mesh over every rank of every process (after
    `initialize_distributed`)."""
    return make_mesh(axis_name=axis_name, device=device)


def per_process_batch(total_batch: int) -> int:
    """Split a global collocation batch across processes evenly."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if total_batch % n:
        raise ValueError(f"batch {total_batch} not divisible by {n} processes")
    return total_batch // n
