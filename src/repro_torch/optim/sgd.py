"""Plain SGD, the paper nets' update (``p - lr * g``, as the reference's
``train_step_fn``s apply it)."""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


def sgd_step(loss, params, lr: float):
    """``(loss, params - lr * grad(loss))`` over a pytree of leaves that
    require grad; the new leaves are detached leaves that require grad, the
    next step's parameters."""
    leaves, spec = tree_flatten(params)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [(p - lr * g).requires_grad_() for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(new, spec)
