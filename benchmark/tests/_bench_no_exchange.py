"""Plants a fault in every rank of a data-parallel run: the exchange of
the gradients and losses between ranks left out."""

import neuralpde_tpu_torch.train as train

train.all_reduce_flat = lambda tensors, group=None: list(tensors)
