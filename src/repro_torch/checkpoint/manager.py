"""Fault-tolerant checkpointing: atomic, manifest-committed, keep-K,
async-capable, checksum-verified, moved to a device on restore.

Counterpart of ``repro.checkpoint.manager``, writing and reading the same
files, so a step either package wrote restores in the other:

    <dir>/step_000000123.tmp/...    (write)
    <dir>/step_000000123/           (os.replace — atomic commit)
        manifest.json               {step, n_arrays, keys, dtypes, shapes,
                                     checksums}
        arrays.npz                  the flattened tree, path-keyed

A tree is nested dicts, lists, tuples and dataclasses (``TrainState``)
whose leaves are tensors, numpy arrays or scalars.  It flattens as
``jax.tree_util`` flattens it there — dict keys sorted, a dataclass's
fields in order as ``.<field>``, depth first — to ``"/"``-joined keys, so
the npz holds its arrays in the same order and the manifest is the same
JSON.

Crash safety: a checkpoint is valid iff the non-``.tmp`` directory exists
with a readable manifest; a process killed mid-save leaves only ``.tmp``
junk that the next save cleans up.  Integrity: the manifest records a
CRC32 of each array's host bytes; ``restore_latest`` re-hashes every array
and treats any mismatch (or an unreadable archive, a torn manifest, a key
set that differs from the template's) as a corrupt step, logs a warning
and walks back to the next-older step instead of raising.

On restore every leaf becomes a tensor: on the template leaf's device if
that leaf is a tensor, else on ``device`` (the JAX package's
reshard-on-restore).  numpy has no bfloat16: a bf16 tensor is stored as its
raw 16 bits, numpy dtype ``|V2``, with manifest dtype ``"bfloat16"`` and
the CRC over those bytes, which is what the reference's ``np.savez`` of a
JAX bf16 array writes; either package's bf16 array restores here bitwise,
to ``torch.bfloat16``.  (The reference's own ``restore_latest`` cannot cast
``|V2`` back to bfloat16, ROADMAP C.9; its ``_load_verified`` reads the
port's bytes.)
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{9})$")

log = logging.getLogger("repro_torch.checkpoint")


class CheckpointCorruptError(RuntimeError):
    """A single step failed integrity checks (caught by the walk-back)."""


BF16_BYTES = np.dtype("V2")     # how numpy stores a bfloat16 array's bits


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (the bytes the manifest hashes); a bf16
    tensor as its raw bits, dtype ``|V2``."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(BF16_BYTES)
        return leaf.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_BYTES else str(arr.dtype)


def _leaves(tree, path=()):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples by index, a dataclass's fields in order (``.name``),
    depth first; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f".{f.name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(p): _host(leaf) for p, leaf in _leaves(tree)}


def _unflatten(tree, new: dict, path=()):
    """``tree``'s structure with each leaf replaced by ``new[path]`` (a
    recursive function, not a closure: a self-calling closure is a
    reference cycle that would hold ``new`` until the garbage collector
    runs)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], new, path + (k,)) for k in tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), new,
                               path + (f".{f.name}",))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, new, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return None if tree is None else new[path]


def _checksum(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save_checkpoint(directory: str, step: int, tree, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "n_arrays": len(flat),
        "keys": sorted(flat.keys()),
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "checksums": {k: _checksum(v) for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(
        (m.group(0) for m in map(_STEP_RE.match, os.listdir(directory)) if m),
    )
    for name in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for name in os.listdir(directory):        # clean torn saves
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def _load_verified(path: str, verify: bool) -> dict[str, np.ndarray]:
    """Load one step's arrays, checked against its manifest.  Raises
    ``CheckpointCorruptError`` on any integrity violation."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except Exception as e:
        raise CheckpointCorruptError(f"unreadable manifest: {e}") from e
    try:
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:
        raise CheckpointCorruptError(f"unreadable arrays.npz: {e}") from e
    keys = manifest.get("keys")
    if keys is not None and set(keys) != set(flat.keys()):
        raise CheckpointCorruptError(
            f"manifest/arrays key mismatch: {set(keys) ^ set(flat.keys())}")
    checksums = manifest.get("checksums")
    if verify and checksums:
        for k, arr in flat.items():
            expect = checksums.get(k)
            got = _checksum(arr)
            if expect is not None and got != expect:
                raise CheckpointCorruptError(
                    f"checksum mismatch for {k!r}: "
                    f"manifest {expect:#010x} != data {got:#010x}")
    return flat


def _to_leaf(arr: np.ndarray, tmpl, dev: torch.device) -> torch.Tensor:
    """A restored array as a tensor of the template leaf's dtype, on its
    device if it is a tensor, else on ``dev``; ``|V2`` bytes as bf16."""
    if arr.dtype == BF16_BYTES:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
        if isinstance(tmpl, torch.Tensor):
            return t.to(device=tmpl.device, dtype=tmpl.dtype)
        return t.to(dev)
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=tmpl.device,
                                                  dtype=tmpl.dtype)
    if hasattr(tmpl, "dtype"):
        arr = arr.astype(tmpl.dtype)
    return torch.from_numpy(np.array(arr)).to(dev)


def restore_latest(directory: str, template, device="cuda",
                   verify: bool = True) -> tuple[Optional[int], Any]:
    """Restore the newest checkpoint that passes integrity checks into the
    template's structure.  Invalid steps (unreadable, checksum-mismatched,
    or key-set-mismatched against the template) are logged and skipped —
    the walk continues to the next-older step, and ``(None, template)`` is
    returned only when nothing valid remains.

    Each leaf comes back as a tensor on the template leaf's device (a
    tensor leaf) or on ``device``.  ``verify=False`` skips the checksum
    re-hashing."""
    # imported here: core.updates imports this module while core loads
    from ..core.types import resolve_device

    dev = resolve_device(device)
    leaves = list(_leaves(template))
    keys = [_key(p) for p, _ in leaves]
    for step in reversed(list_steps(directory)):
        path = os.path.join(directory, f"step_{step:09d}")
        try:
            flat = _load_verified(path, verify)
            if set(keys) != set(flat.keys()):
                raise CheckpointCorruptError(
                    f"template structure mismatch: {set(keys) ^ set(flat.keys())}")
        except Exception as e:
            log.warning("skipping checkpoint %s (%s); walking back", path, e)
            continue
        new = {p: _to_leaf(flat[k], tmpl, dev)
               for (p, tmpl), k in zip(leaves, keys)}
        return step, _unflatten(template, new)
    return None, template


class CheckpointManager:
    """Periodic (optionally async) checkpointing around a loop."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.every != 0:
            return False
        self.wait()
        # host copies now, so the thread never reads tensors the caller
        # goes on to change
        host_tree = _unflatten(tree, {p: np.array(_host(leaf))
                                      for p, leaf in _leaves(tree)})
        if self.async_save:
            self._thread = threading.Thread(
                target=save_checkpoint,
                args=(self.directory, step, host_tree, self.keep), daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.directory, step, host_tree, self.keep)
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template, device="cuda", verify: bool = True):
        return restore_latest(self.directory, template, device, verify)
