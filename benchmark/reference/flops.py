"""Operations and bytes of a step, counted from the configuration's shapes,
and the card's published peaks.

Model FLOPs count the matrix products the mathematics needs, whatever the
program executes: no recomputation of checkpointed microbatches, no second
primal pass, no elementwise work.  A dense Taylor-mode step carries, at each
layer, the primal column and two series columns (first and second order)
per coordinate direction, so ``1 + 2 * dim`` columns at an interior point
and the primal alone at a boundary point; a backward pass costs twice its
forward pass.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12


def layer_flops(layers) -> int:
    """Multiply-add FLOPs of one column through dense layers of these
    widths (``[2, 64, 64, 1]``): ``2 * in * out`` a layer."""
    return sum(2 * a * b for a, b in zip(layers, layers[1:]))


def dense_step_flops(layers, interior: int, boundary: int) -> int:
    """Model FLOPs of one training step of a dense Taylor-mode Laplacian
    residual at ``interior`` points and value-only boundary terms at
    ``boundary`` points in all, forward and backward."""
    dim = layers[0]
    per_column = layer_flops(layers)
    forward = per_column * ((1 + 2 * dim) * interior + boundary)
    return 3 * forward


def separable_step_flops(axis_layers, rank: int, nodes: int,
                         dim: int = 2) -> int:
    """Model FLOPs of one step of a separable Laplacian residual on a
    ``nodes ** dim`` grid: each axis net at its nodes with value, first and
    second derivative columns, and the rank contraction of the two
    Laplacian terms (``dim`` products of ``nodes**dim * rank`` multiply-adds
    forward, two products a factor backward)."""
    if dim != 2:
        raise ValueError("the contraction count is written for two axes")
    axes = 3 * dim * nodes * 3 * layer_flops(axis_layers)
    grid = nodes ** dim
    contraction = 2 * dim * grid * rank * 3
    return axes + contraction


def tanh_jet2_bytes(numel: int, itemsize: int, kind: str) -> int:
    """Bytes one ``tanh_jet2`` call must move at ``numel`` elements a
    tensor: forward reads z, z1, z2 and writes three outputs; backward
    reads those three and three cotangents and writes three."""
    tensors = {"forward": 6, "backward": 9}[kind]
    return tensors * numel * itemsize
