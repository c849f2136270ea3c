"""Loss and gradient of a model over a nested dict of params (the
reference's ``jax.value_and_grad(model.loss, has_aux=True)``)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, unflatten


def _in_layout_of(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` with ``p``'s strides.  Autograd hands a parameter used
    through a permuted view (ResNet's HWIO weights, seen as OIHW by the
    convolution) a gradient in the view's layout; the pending buffers,
    the collectives and the fused update's kernel read raw memory in the
    parameter's layout."""
    if g.stride() == p.stride():
        return g
    return torch.empty_like(p, dtype=g.dtype).copy_(g)


def value_and_grad(loss_fn, params, batch, wrap=None):
    """Returns (loss, metrics, grads): loss and metrics detached, grads a
    tree like ``params`` in the params' dtypes and strides.  The params
    are used through detached aliases, so the caller's tensors need no
    ``requires_grad`` and may be updated in place afterwards.  ``wrap``
    maps the list of aliases to the params tree the loss reads (the
    FSDP step's gathers, whose backward hands each alias its
    gradient)."""
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = loss_fn(wrap(ps) if wrap else unflatten(params, ps),
                                batch)
        grads = torch.autograd.grad(loss, ps)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, [_in_layout_of(g, p)
                               for g, p in zip(grads, ps)]))
