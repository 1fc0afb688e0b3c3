"""Holding a nested NamedTuple of tensors in a module.

The port's problem objects (``LocCMTProblem``, ``RickerProblem``) are
NamedTuples whose fields are tensors, plain values or further NamedTuples,
the counterpart of the JAX package's pytrees.
"""

from __future__ import annotations

import torch
from torch import nn


class TensorTreeModule(nn.Module):
    """A module whose buffers are the tensors of one nested NamedTuple.

    Each tensor becomes a buffer named by its field path (``targets__t__x``),
    so ``.to(device)`` or ``.double()`` moves and casts them like any
    buffers; :meth:`tree` rebuilds the NamedTuple from the current buffers.
    """

    def __init__(self, tree):
        super().__init__()
        # the structure alone: a tensor's place holds None, its value a buffer
        self._template = self._walk(tree, "", self._hold)

    def _hold(self, path: str, leaf):
        if isinstance(leaf, torch.Tensor):
            self.register_buffer(path, leaf)
            return None
        return leaf

    def _walk(self, node, prefix: str, leaf):
        """Rebuild ``node`` with ``leaf(path, value)`` at every non-tuple field."""
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(self._walk(v, f"{prefix}{name}__", leaf)
                                for name, v in zip(node._fields, node)))
        return leaf(prefix[:-2], node)

    def tree(self):
        buffers = dict(self.named_buffers(recurse=False))
        return self._walk(self._template, "", lambda path, v: buffers.get(path, v))
