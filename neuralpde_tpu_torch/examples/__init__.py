"""The example programs of `examples/` (the JAX package's) in the port.

One module per example script, under the same name, each run as

    python -m neuralpde_tpu_torch.examples.<name> [flags] [--device D]

with the script's flags, on one card (``--device`` defaults to ``cuda``;
without a card it fails with torch's own error). Each module exposes its
recipe as ``run(...)``, which returns a dict with ``rel_l2`` (the example's
error measure) and ``wall_s``, and ``per_stage`` where the recipe has
stages, and its construction functions (the system, the nets, the error
measure) with no side effects at import. Nothing here imports JAX: the
modules are written against `neuralpde_tpu_torch` alone.

The separable recipes (`beltrami_spinn`, `taylor_green_spinn`,
`helmholtz3d_spinn`, `allen_cahn_spinn`), the dense ones
(`taylor_green_ns`, `allen_cahn_causal`, `kuramoto_sivashinsky`,
`poisson_2d`, `burgers_dgm`, `fbpinn_multiscale`), Gauss-Newton
(`gauss_newton_frontier`), the operators (`burgers_pino`,
`ns_vorticity_pino`), the stochastic layer (`gbm_sde`,
`lotka_volterra_bpinn`), export (`export_serving`) and data-parallel
training under ``torchrun`` (`sharded_training`).
"""
