"""``paddle_tpu.incubate.asp`` counterpart: automatic n:m structured
sparsity (2:4 by default): the masks, ``prune_model`` and the optimizer
wrapper that keeps pruned weights at zero.

A Tensor's mask is made on its device by a double argsort within each
group of ``m`` along the last dim (stable, so ties fall as in the JAX
package and the masks agree bit for bit); a numpy array's on the host.
The mask is multiplied into the weight after each optimizer step, as in
the JAX package; sparse tensor cores (cuSPARSELt's 2:4 products) are
not used, so the pruned matmuls cost what the dense ones do.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor

__all__ = ["calculate_density", "create_mask", "check_mask_2d",
           "prune_model", "decorate", "OptimizerWithSparsityGuarantee",
           "reset_excluded_layers", "set_excluded_layers"]

_EXCLUDED: set = set()
# id(leaf) -> (leaf, mask), filled by prune_model and read by every
# OptimizerWithSparsityGuarantee, so an optimizer decorated before the
# model is pruned (the usual order) still keeps the sparsity
_MASK_REGISTRY: dict = {}


def _leaf(p):
    return p._value if isinstance(p, Tensor) else p


def calculate_density(x) -> float:
    """The share of nonzero entries (one number read from the device)."""
    if isinstance(x, (Tensor, torch.Tensor)):
        v = _leaf(x).detach()
        return float((v != 0).float().mean().item())
    arr = np.asarray(x)
    return float((arr != 0).sum() / arr.size)


def create_mask(tensor, func_name="mask_2d_best", n=2, m=4):
    """The n:m mask along the last dim: the ``n`` largest |w| of every
    group of ``m`` kept.  A Tensor (or torch tensor) gives a torch mask on
    its device, in its dtype; a numpy array a numpy mask."""
    if isinstance(tensor, (Tensor, torch.Tensor)):
        arr = _leaf(tensor).detach()
        if arr.ndim < 1 or arr.shape[-1] % m:
            return torch.ones_like(arr)
        groups = torch.abs(arr).reshape(-1, m)
        order = torch.argsort(-groups, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)  # each entry's rank
        return (rank < n).to(arr.dtype).reshape(arr.shape)
    arr = np.asarray(tensor)
    if arr.ndim < 1 or arr.shape[-1] % m:
        return np.ones_like(arr)
    groups = np.abs(arr).reshape(-1, m)
    order = np.argsort(-groups, axis=1)[:, :n]
    mask = np.zeros_like(groups)
    np.put_along_axis(mask, order, 1.0, axis=1)
    return mask.reshape(arr.shape).astype(arr.dtype)


def check_mask_2d(mask, n=2, m=4) -> bool:
    if isinstance(mask, (Tensor, torch.Tensor)):
        mask = _leaf(mask).detach().cpu().numpy()
    arr = np.asarray(mask)
    if arr.shape[-1] % m:
        return False
    groups = arr.reshape(-1, m)
    return bool((groups.sum(axis=1) == n).all())


def set_excluded_layers(param_names, main_program=None):
    _EXCLUDED.update(param_names)


def reset_excluded_layers(main_program=None):
    _EXCLUDED.clear()


def _prunable(p) -> bool:
    return (not p.stop_gradient and p.name not in _EXCLUDED and
            len(p.shape) == 2 and p.shape[-1] % 4 == 0)


def _apply_mask(leaf, mask):
    with torch.no_grad():
        leaf.mul_(mask)


def prune_model(model, n=2, m=4, mask_algo="mask_2d_best", with_mask=True):
    """Apply n:m masks to every prunable 2-D weight; returns
    ``{name: mask}``."""
    masks = {}
    for p in model.parameters():
        if not _prunable(p):
            continue
        leaf = _leaf(p)
        mask = create_mask(p, n=n, m=m)
        _apply_mask(leaf, mask)
        masks[p.name] = mask
        _MASK_REGISTRY[id(leaf)] = (leaf, mask)
    return masks


class OptimizerWithSparsityGuarantee:
    """``asp.decorate``'s result: after each optimizer step the masks are
    applied again, so pruned entries stay zero."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._masks = {}  # id(leaf) -> (leaf, mask)

    def _register(self, masks_by_param):
        self._masks = {id(_leaf(p)): (_leaf(p), m)
                       for p, m in masks_by_param}

    def step(self):
        self._optimizer.step()
        for p in self._optimizer._parameters:
            leaf = _leaf(p)
            entry = self._masks.get(id(leaf)) or _MASK_REGISTRY.get(id(leaf))
            if entry is not None and entry[0] is leaf:
                _apply_mask(leaf, entry[1])

    def __getattr__(self, name):
        return getattr(self.__dict__["_optimizer"], name)


def decorate(optimizer, model=None, n=2, m=4):
    """Wrap ``optimizer``; with ``model``, prune it now and register the
    masks."""
    wrapped = OptimizerWithSparsityGuarantee(optimizer)
    if model is not None:
        masks = prune_model(model, n=n, m=m)
        by_param = [(p, masks[p.name]) for p in model.parameters()
                    if p.name in masks]
        wrapped._register(by_param)
    return wrapped
