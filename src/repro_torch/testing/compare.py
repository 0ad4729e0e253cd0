"""Bitwise comparison of port indexes (a rebuilt shard against its build)."""

from __future__ import annotations

import dataclasses

import torch


def indexes_equal(a, b) -> bool:
    """True iff two port indexes (``GraphIndex``, ``EMQGIndex`` or any
    dataclass of tensors and scalars) hold the same fields: every tensor of
    the same dtype and equal to the bit, every scalar equal, nested
    dataclasses alike."""
    if type(a) is not type(b):
        return False
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            if not indexes_equal(x, y):
                return False
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True
