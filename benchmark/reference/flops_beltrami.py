"""Model FLOPs of one step of the Beltrami SPINN, counted from the
configuration's shapes by the rules of `reference.flops`: the matrix
products the mathematics needs, whatever the program executes, a backward
pass twice its forward, no elementwise work.

* The interior grid: each distinct grid tensor the four equations need,
  formed once by a rank contraction of ``2 r N_x N_y N_z N_t`` FLOPs: u, v
  and w each with its value, its first derivatives in x, y, z and t and its
  second in x, y and z (8 each), and p's three first derivatives: 27.  (The
  program forms 36: each momentum equation forms u, v and w anew, and
  continuity u_x, v_y and w_z.)
* The conditions: each of the 21 three-axis conditions' grids once, ``2 r``
  FLOPs a point, and the gauge's ``N_t`` points.
* The axis nets: each at its axis's nodes with one column for the value
  and one for each derivative order the equations take of it
  (`reference.beltrami.ORDERS`), and at each constant point of a condition
  with one column: seven for each of u, v and w (x, y, z = -1 and 1, t = 0),
  three for p (the gauge's x, y, z = 0).
"""

from __future__ import annotations

from reference import flops
from reference.beltrami import ORDERS

INTERIOR_TENSORS = 27
CONSTANT_COLUMNS = 3 * 7 + 3


def step_flops(axis_layers, rank: int, counts) -> int:
    """Model FLOPs of one step on the grid of ``counts`` nodes on the axes
    x, y, z, t."""
    nx, ny, nz, nt = counts
    interior = INTERIOR_TENSORS * 2 * rank * nx * ny * nz * nt
    faces = 2 * (ny * nz + nx * nz + nx * ny) * nt
    conditions = 2 * rank * (3 * (nx * ny * nz + faces) + nt)
    columns = sum(n * (order + 1) for orders in ORDERS.values()
                  for n, order in zip(counts, orders)) + CONSTANT_COLUMNS
    axes = flops.layer_flops(axis_layers) * columns
    return 3 * (interior + conditions + axes)
