"""Loss and gradient of a model over a nested dict of params (the
reference's ``jax.value_and_grad(model.loss, has_aux=True)``)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, unflatten


def value_and_grad(loss_fn, params, batch):
    """Returns (loss, metrics, grads): loss and metrics detached, grads a
    tree like ``params`` in the params' dtypes.  The params are used
    through detached aliases, so the caller's tensors need no
    ``requires_grad`` and may be updated in place afterwards."""
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = loss_fn(unflatten(params, ps), batch)
        grads = torch.autograd.grad(loss, ps)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))
