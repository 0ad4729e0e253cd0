"""Packed visited bitsets for lock-step graph traversal.

Counterpart of ``repro.core.bitset``.  Layout: bit ``j`` of word ``w`` in
row ``b`` ⇔ node ``32·w + j`` seen by query ``b`` — 32 bits per word, as in
the JAX package.  The words are held in ``int64`` tensors with values in
``[0, 2**32)``: the one-bit masks then add without sign trouble (bit 31 of
an ``int32`` is negative) and ``>>``, ``gather`` and ``scatter_add_`` all
exist for the type.  ``bitset_to_uint32`` gives the JAX package's words.

Unlike the JAX functions, ``bitset_set`` and ``bitset_clear`` update their
argument in place (a full-size delta array per hop would be 128 MiB at
n = 1M and B = 1024) and return it.  Invalid (negative) ids never test
positive and never set or clear a bit: the JAX package scatters them out of
bounds with ``mode="drop"``; here they add a zero to word 0, which is the
same no-op without an out-of-bounds index.
"""

from __future__ import annotations

import numpy as np
import torch

_WORD_BITS = 32


def bitset_words(n: int) -> int:
    """Number of 32-bit words needed to cover ``n`` node ids."""
    return (n + _WORD_BITS - 1) // _WORD_BITS


def bitset_make(batch: int, n: int, device=None) -> torch.Tensor:
    """Empty bitset: ``int64[batch, ceil(n/32)]`` holding 32 bits a word."""
    return torch.zeros((batch, bitset_words(n)), dtype=torch.int64,
                       device=device)


def bitset_to_uint32(bits: torch.Tensor) -> np.ndarray:
    """The JAX package's ``uint32`` words for ``bits``."""
    return bits.cpu().numpy().astype(np.uint32)


def _split(ids: torch.Tensor):
    safe = ids.clamp_min(0).long()
    return safe >> 5, safe & 31


def bitset_test(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Membership test.  bits int64[B, nw], ids int32[B, K] → bool[B, K].
    Invalid (negative) ids test False."""
    word, bit = _split(ids)
    hit = ((bits.gather(1, word) >> bit) & 1) != 0
    return hit & (ids >= 0)


def _scatter_bits(bits: torch.Tensor, ids: torch.Tensor, set_: bool):
    # Each valid id is unique in its row, so each (word, bit) pair is hit at
    # most once: adding the masks of the bits that must flip is exactly an
    # or (set) or an and-not (clear), with no carry between bits.
    word, bit = _split(ids)
    mask = torch.ones_like(bit) << bit
    is_set = ((bits.gather(1, word) >> bit) & 1) != 0
    flip = (ids >= 0) & (is_set != set_)
    delta = torch.where(flip, mask if set_ else -mask, torch.zeros_like(mask))
    return bits.scatter_add_(1, word, delta)


def bitset_set(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Set the bits for ``ids`` in place (valid ids unique per row)."""
    return _scatter_bits(bits, ids, True)


def bitset_clear(bits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Clear the bits for ``ids`` in place (valid ids unique per row); the
    exact inverse of ``bitset_set``.  Clearing an unset bit is a no-op."""
    return _scatter_bits(bits, ids, False)


def unique_per_row(ids: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
    """Per-row unique valid entries of ``ids`` among ``fresh``.

    ids int32[B, K], fresh bool[B, K] → int32[B, K] sorted ascending, with
    duplicates and non-fresh entries replaced by -1 *in place*: the holes
    are not compacted (``[[3, 3, 5, -1]]`` → ``[[3, -1, 5, -1]]``), exactly
    as the JAX package lays them out, because the merge's tie order depends
    on column position.
    """
    big = 2 ** 30
    s = torch.sort(torch.where(fresh, ids, torch.full_like(ids, big)),
                   dim=1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    keep = first & (s < big)
    return torch.where(keep, s, torch.full_like(s, -1))
