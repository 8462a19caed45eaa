"""Device mesh and collocation-batch sharding (`neuralpde_tpu.parallel.mesh`).

The JAX package shards in one controller: GSPMD partitions a jitted loss
over a `jax.sharding.Mesh` and inserts the collectives.  PyTorch runs one
process a device, so here a `Mesh` is this rank's view of a
`torch.distributed` process group (one axis) or of a 2-D `DeviceMesh`
(``("data", "model")``), and the collectives are explicit.  The results are
the JAX package's: a run under a mesh of W ranks gives the loss, gradient
and trained parameters of the run without one, up to the order of the sums.

The rule that makes this so is the *rank share*.  Under an active mesh every
rank draws the **global** batch (the solve's generator is seeded alike on
every rank) and `shard_batch` keeps its contiguous slice of the points.  A
loss term then returns this rank's share of its value: for a mean over N
points, the sum over the rank's points over N; for a term that was not
sharded (N does not divide W, or the term has no points), the whole value
over W.  The shares of all ranks sum to the value, so the training step
all-reduces (sums) the gradients and the reported losses over the data axis
once a step (`train.TrainStep`), and a term counted whole on every rank
still counts once.  A quantity that enters the loss other than linearly (the
causal weights) is all-reduced inside the loss, without a gradient.

Usage, one process a device (``torchrun --nproc-per-node=4 script.py``):

    initialize_distributed()                 # NCCL, from torchrun's env
    mesh = make_mesh()                       # all ranks, axis "data"
    with use_mesh(mesh):
        prob = discretize(system, disc)
        res = solve(prob, ...)               # same result on every rank

Without an active mesh nothing here changes a computation: `shard_batch`
returns its argument and no collective runs.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

_ACTIVE_MESH: "Mesh | None" = None
BATCH_AXIS = "data"
MODEL_AXIS = "model"


@dataclass
class Mesh:
    """This rank's view of a device mesh.

    ``shape`` maps each axis name to its size, in ``axis_names`` order (the
    last axis is the fast one: rank = ``data_index * n_model +
    model_index``); ``coords`` is this rank's index along each axis and
    ``groups`` the process group of the ranks that differ from it only
    along that axis.  ``device`` is the rank's
    device; ``device_mesh`` the 2-D `DeviceMesh` of `make_mesh_2d`."""

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    device_mesh: object = field(default=None, repr=False)

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def _require_group() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a torch.distributed process group: "
            "call parallel.distributed.initialize_distributed() first")


def _rank_device(device) -> torch.device:
    """``device`` as given, or this rank's card ``cuda:{LOCAL_RANK}`` (for
    None and for a ``"cuda"`` without an index)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.device("cuda", dist.get_rank()
                            % max(torch.cuda.device_count(), 1))
    return torch.device("cuda", int(local))


def make_mesh(n_devices: int | None = None, axis_name: str = BATCH_AXIS,
              device=None) -> Mesh:
    """A 1-D mesh over every rank of the initialized process group.

    ``n_devices`` (if given) must be the group's size: one process drives
    one device, and a mesh spans every rank.  Asking for more devices than
    the group has raises, with no fallback to other devices.  ``device`` is
    this rank's device (default ``cuda:{LOCAL_RANK}``; pass ``"cpu"`` for a
    gloo group)."""
    _require_group()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"requested {n_devices} devices, the process group has {world} "
            "ranks; a mesh spans every rank (one process a device)")
    return Mesh((axis_name,), {axis_name: world},
                {axis_name: dist.get_rank()}, {axis_name: dist.group.WORLD},
                _rank_device(device))


def make_mesh_2d(n_data: int, n_model: int, device=None) -> Mesh:
    """2-D ``(data, model)`` mesh: the collocation batch over ``data``, wide
    layers tensor-parallel over ``model``, which is the fast axis (ranks
    ``d * n_model + m``), so that a model group holds neighbouring ranks."""
    _require_group()
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"requested a {n_data}x{n_model} mesh, the process "
                         f"group has {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    dev = _rank_device(device)
    dm = init_device_mesh(dev.type, (n_data, n_model),
                          mesh_dim_names=(BATCH_AXIS, MODEL_AXIS))
    axes = (BATCH_AXIS, MODEL_AXIS)
    return Mesh(axes, {BATCH_AXIS: n_data, MODEL_AXIS: n_model},
                {a: dm.get_local_rank(a) for a in axes},
                {a: dm.get_group(a) for a in axes}, dev, dm)


def get_mesh() -> Mesh | None:
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    global _ACTIVE_MESH
    if not isinstance(mesh, Mesh):
        raise TypeError(f"use_mesh takes a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


@contextlib.contextmanager
def no_mesh():
    """Deactivate the ambient mesh for the body.  Drivers that own the
    device axis themselves (ensemble members, MCMC chains) build and run
    their losses under it, so that those do not also shard their batch."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = None
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


def check_mesh(mesh) -> Mesh | None:
    """``mesh`` if it is None or a `Mesh`; anything else raises TypeError
    (the ``mesh=`` argument of the ensemble, chain and PINO drivers)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a parallel.mesh.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on the mesh: split along dimension ``dim`` over
    mesh axis ``axis``, or replicated (``axis`` None)."""

    axis: str | None = None
    dim: int | None = None


def batch_sharding(mesh: Mesh) -> Placement:
    """The trailing (points) axis of a ``(dim, N)`` matrix over ``data``."""
    del mesh
    return Placement(BATCH_AXIS, -1)


def replicated(mesh: Mesh) -> Placement:
    del mesh
    return Placement()


# ---------------------------------------------------------------------------
# The data axis: slices and shares
# ---------------------------------------------------------------------------

def data_size() -> int:
    """Ranks along the active mesh's data axis (1 without a mesh)."""
    mesh = _ACTIVE_MESH
    return 1 if mesh is None else mesh.shape.get(BATCH_AXIS, 1)


def data_rank() -> int:
    """This rank's index along the active mesh's data axis (0 without)."""
    mesh = _ACTIVE_MESH
    return 0 if mesh is None else mesh.coords.get(BATCH_AXIS, 0)


def _slice_last(x, dim: int):
    mesh = _ACTIVE_MESH
    n = mesh.shape[BATCH_AXIS]
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.coords[BATCH_AXIS] * k, k)


def shard_batch(x):
    """This rank's contiguous slice of the trailing (points) axis of a
    ``(dim, N)`` collocation matrix under the active mesh.  ``x`` itself
    when no mesh is active, the data axis has one rank, ``x`` has fewer than
    two dimensions, or N does not divide by the axis (the caller then counts
    the term whole on every rank, at 1/W each; module note)."""
    n = data_size()
    if n == 1 or x.ndim < 2 or x.shape[-1] % n != 0:
        return x
    return _slice_last(x, x.ndim - 1)


def shard_axis_nodes(x):
    """`shard_batch` for a 1-D node array (separable tensor grids): each
    rank keeps its slice of axis 0's nodes and contracts its rows of the
    factorized grid."""
    n = data_size()
    if n == 1 or x.ndim != 1 or x.shape[0] % n != 0:
        return x
    return _slice_last(x, 0)


def share(value):
    """This rank's share of a term that every rank computed whole: the
    value over the data-axis size (the value itself without a mesh)."""
    n = data_size()
    return value if n == 1 else value / n


def sum_over_data(t: torch.Tensor) -> torch.Tensor:
    """The sum over the data axis of a tensor that carries no gradient (the
    global value of per-rank shares); ``t`` itself without a mesh."""
    if data_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=_ACTIVE_MESH.groups[BATCH_AXIS])
    return out


def gather_over_data(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (no gradient) concatenated along dimension 0 in
    the order of the data axis; ``t`` itself without a mesh."""
    n = data_size()
    if n == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=_ACTIVE_MESH.groups[BATCH_AXIS])
    return torch.cat(parts)


def gather_ranks(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dimension 0 in rank order, over
    all the ranks of ``mesh`` (no gradient): the results of a member or
    chain axis sharded over the whole mesh, whole on every rank."""
    if mesh.size == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def mesh_slice(n: int, mesh: Mesh, what: str) -> slice:
    """This rank's contiguous block of ``n`` items sharded over every rank
    of ``mesh`` (rank r holds items ``r·n/W ... (r+1)·n/W - 1``)."""
    if n % mesh.size != 0:
        raise ValueError(f"{what}={n} must be a multiple of the mesh size "
                         f"{mesh.size}")
    k = n // mesh.size
    r = dist.get_rank() if mesh.size > 1 else 0
    return slice(r * k, (r + 1) * k)


def all_reduce_flat(tensors: list, group=None) -> list:
    """Sum every tensor of ``tensors`` over ``group`` with one collective
    for each dtype (the tensors flattened into one bucket); returns the
    summed tensors, new, in ``tensors``' shapes."""
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        real = torch.view_as_real(t) if t.is_complex() else t
        by_dtype.setdefault(real.dtype, []).append((i, t, real))
    for items in by_dtype.values():
        flat = torch.cat([r.reshape(-1) for _, _, r in items])
        dist.all_reduce(flat, group=group)
        offset = 0
        for i, t, real in items:
            n = real.numel()
            part = flat[offset:offset + n].view(real.shape)
            out[i] = torch.view_as_complex(part) if t.is_complex() else part
            offset += n
    return out


# ---------------------------------------------------------------------------
# Parameters: replicated and tensor-parallel
# ---------------------------------------------------------------------------

def replicate_params(params: dict, mesh: Mesh | None = None) -> dict:
    """Rank 0's parameters on every rank of the mesh (a broadcast), on each
    rank's device."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        return params
    out = {}
    for k, v in params.items():
        t = v.detach().to(mesh.device).clone()
        if mesh.size > 1:
            dist.broadcast(t, src=0)
        out[k] = t
    return out


def _layer_index(name: str) -> int | None:
    if name.startswith("layer_") and name[len("layer_"):].isdigit():
        return int(name[len("layer_"):])
    return None


def _tp_placement(name: str, shape, n: int, axis: str = MODEL_AXIS):
    """The Megatron placement of the flat parameter ``name``: the innermost
    ``layer_<i>`` of its path decides; an even layer is column-parallel
    (weight and bias split along their output rows), an odd one
    row-parallel (weight split along its input columns, bias whole).  A
    leaf that is not a 2-D ``weight``/``bias`` of a ``layer_<i>``, or whose
    split dimension does not divide by ``n``, stays replicated."""
    parts = name.split(".")
    layer = None
    for p in parts[:-1]:
        idx = _layer_index(p)
        if idx is not None:
            layer = idx
    leaf = parts[-1]
    if layer is None or len(shape) != 2 or leaf not in ("weight", "bias"):
        return Placement()
    col = layer % 2 == 0
    if leaf == "weight":
        if col and shape[0] % n == 0:
            return Placement(axis, 0)
        if not col and shape[1] % n == 0:
            return Placement(axis, 1)
        return Placement()
    if col and shape[0] % n == 0:
        return Placement(axis, 0)
    return Placement()


def shard_params_tp(params: dict, mesh: Mesh | None = None,
                    axis: str = MODEL_AXIS):
    """Megatron-style tensor parallelism for `Dense` chains
    (`neuralpde_tpu.parallel.mesh.shard_params_tp`'s rule, `_tp_placement`)
    -> ``(local, placements)``: this rank's slice of every parameter along
    the model axis, and each parameter's `Placement`.  `Dense` recognises a
    sliced weight by its shape: a column-parallel layer computes its output
    rows with no collective, a row-parallel one all-reduces its partial
    product over the model axis and then adds its bias."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None or axis not in mesh.shape:
        return dict(params), {k: Placement() for k in params}
    n, r = mesh.shape[axis], mesh.coords[axis]
    local, places = {}, {}
    for k, v in params.items():
        pl = _tp_placement(k, tuple(v.shape), n, axis)
        places[k] = pl
        if pl.axis is None:
            local[k] = v
        else:
            size = v.shape[pl.dim] // n
            local[k] = v.narrow(pl.dim, r * size, size).clone()
    return local, places


def model_group():
    """The active mesh's model-axis group, or None when it has no model
    axis of more than one rank (no tensor parallelism)."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) == 1:
        return None
    return mesh.groups[MODEL_AXIS]


class ReduceFromModel(torch.autograd.Function):
    """Sum over the model axis; the cotangent passes through (each rank's
    partial product gets the gradient of the whole)."""

    @staticmethod
    def forward(x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        y = t.clone()
        dist.all_reduce(y, group=ctx.group)
        return y


class CopyToModel(torch.autograd.Function):
    """The identity into a column-parallel layer; the cotangents of the
    ranks' output slices are summed over the model axis."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        return t


class GatherFromModel(torch.autograd.Function):
    """Concatenate the ranks' row slices along dimension 0; the cotangent's
    own rows go back to each rank."""

    @staticmethod
    def forward(x, group):
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]
        ctx.rows = inputs[0].shape[0]

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(0, r * ctx.rows, ctx.rows), None

    @staticmethod
    def jvp(ctx, t, _):
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, t, group=ctx.group)
        return torch.cat(parts, dim=0)
