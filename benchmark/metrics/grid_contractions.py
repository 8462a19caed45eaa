"""Grid contractions a step: the program's count of the rank contractions
that write a tensor over two or more grid axes, summed over the losses
(``SeparableTraining.grid_contractions``, counted once when the losses are
built); nothing where the program keeps no such count."""


def read(layer: dict):
    return layer.get("grid_contractions")
