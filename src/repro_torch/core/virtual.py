"""Virtual-cluster implementations of the paper's Algorithms 1-3
(``repro/core/virtual.py``): one device, workers as a Python loop, no
collectives.  They exist to check the paper's central claim (§3, §4.2):
serial SGD, CSGD and LSGD give the same parameter sequence for the same
minibatch partition, hyper-parameters and w0.

Each function copies ``params`` first (the port's optimizer updates in
place) and returns (params, losses).  Gradient means sum the workers in
order and divide once, as the reference's ``sum(xs) / len(xs)`` does,
accumulating as the workers go so that one worker's gradient is alive at
a time besides the sum.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.core.autodiff import value_and_grad
from repro_torch.optim.sgd import OptimConfig, apply_update, init_state
from repro_torch.tree import tree_map


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


class _Mean:
    """Running ``sum(trees) / len(trees)`` in the order trees are added."""

    def __init__(self):
        self.total = None
        self.n = 0

    def add(self, tree):
        if self.total is None:
            self.total = _clone(tree)
        else:
            tree_map(lambda a, x: a.add_(x), self.total, tree)
        self.n += 1

    def result(self):
        return tree_map(lambda a: a / self.n, self.total)


def serial_sgd(model, params, batches, lr_fn, ocfg: OptimConfig):
    """Alg. 1: full-minibatch SGD; ``batches[t]`` is the minibatch M_t."""
    params = _clone(params)
    opt = init_state(params, ocfg)
    losses = []
    for t, batch in enumerate(batches):
        loss, _, g = value_and_grad(model.loss, params, batch)
        apply_update(params, opt, g, lr_fn(t), ocfg)
        losses.append(float(loss))
    return params, losses


def csgd(model, params, worker_batches, lr_fn, ocfg: OptimConfig):
    """Alg. 2: N workers, flat all-reduce mean each step;
    ``worker_batches[t]`` is the list of the N shards M_t^i."""
    params = _clone(params)
    opt = init_state(params, ocfg)
    losses = []
    for t, shards in enumerate(worker_batches):
        mean, step_losses = _Mean(), []
        for s in shards:
            loss, _, g = value_and_grad(model.loss, params, s)
            mean.add(g)
            step_losses.append(float(loss))
        losses.append(sum(step_losses) / len(step_losses))
        apply_update(params, opt, mean.result(), lr_fn(t), ocfg)
    return params, losses


def lsgd(model, params, worker_batches, lr_fn, ocfg: OptimConfig,
         group_size: int, *, finalize: bool = True):
    """Alg. 3: workers in nodes of ``group_size``; the step-t update is
    applied at the top of step t+1 (deferred past the communicator
    all-reduce).  With ``finalize`` the trailing pending update is
    flushed, so the result compares with CSGD after as many steps."""
    params = _clone(params)
    opt = init_state(params, ocfg)
    pending = None
    losses = []
    for t, shards in enumerate(worker_batches):
        n = len(shards)
        assert n % group_size == 0
        # line 10: the deferred update of step t-1
        if pending is not None:
            apply_update(params, opt, pending, lr_fn(t - 1), ocfg)
        # lines 3-6: local gradients at the updated parameters, reduced
        # to each node's communicator
        node_means, step_losses = _Mean(), []
        for first in range(0, n, group_size):
            node = _Mean()
            for s in shards[first:first + group_size]:
                loss, _, g = value_and_grad(model.loss, params, s)
                node.add(g)
                step_losses.append(float(loss))
            node_means.add(node.result())
        losses.append(sum(step_losses) / len(step_losses))
        # line 8: all-reduce over the communicators
        pending = node_means.result()
    if finalize and pending is not None:
        apply_update(params, opt, pending, lr_fn(len(worker_batches) - 1),
                     ocfg)
    return params, losses


def partition_minibatch(batch: Dict[str, torch.Tensor],
                        n_workers: int) -> List[Dict[str, Any]]:
    """Split a global batch into N per-worker shards (rows
    [i*B/N, (i+1)*B/N), the paper's {M^i} partition of M)."""
    out = []
    for i in range(n_workers):
        shard = {}
        for k, leaf in batch.items():
            b = leaf.shape[0]
            assert b % n_workers == 0
            per = b // n_workers
            shard[k] = leaf[i * per:(i + 1) * per]
        out.append(shard)
    return out
