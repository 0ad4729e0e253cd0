"""Arch / shape registry of the port: a copy of the part of
``repro.configs.base`` that the ported models use (``ShapeSpec``,
``ArchSpec``, ``lm_shapes``, ``recsys_shapes``, ``register``,
``get_arch``), with only the fields and shapes that a port path reads.

An arch's module is listed in ``_ARCH_MODULES`` once its model is ported:
smollm-135m came with the LM slice, the other four LM archs with the MoE
slice, fm, dcn-v2, dien and mind with the recsys slice, gat-cora with the
GNN slice.  ``family`` ("lm", "recsys", "gnn") says which of
``launch.train``'s loops trains an arch.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                   # train | prefill | serve | retrieval |
    #                             full_graph | minibatch | molecule
    dims: dict                  # family-specific dimensions
    accum_steps: int = 1        # microbatch accumulation for train kinds


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str                 # lm | recsys | gnn
    model_cfg: Any              # the family's config dataclass
    shapes: dict[str, ShapeSpec]
    source: str = ""            # provenance note
    smoke_cfg: Any = None       # reduced config for CPU tests


_ARCH_MODULES = [
    "moonshot_v1_16b_a3b",
    "llama4_maverick_400b_a17b",
    "internlm2_20b",
    "phi3_mini_3_8b",
    "smollm_135m",
    "mind",
    "dien",
    "fm",
    "dcn_v2",
    "gat_cora",
]

_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if not _REGISTRY:
        for mod in _ARCH_MODULES:
            importlib.import_module(f"repro_torch.configs.{mod}")
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def lm_shapes(accum_train: int = 8) -> dict[str, ShapeSpec]:
    """The reference's LM shapes that a port path runs: ``train_4k``
    (``launch.train`` and ``chip_smoke.py``'s train phase, the batch cut to
    what one card holds) with the arch's microbatch accumulation, and
    ``prefill_32k`` (``chip_smoke.py``'s prefill, its batch cut to 1).  The
    decode shapes come with the slice that runs them."""
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              {"seq": 4096, "batch": 256},
                              accum_steps=accum_train),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 {"seq": 32768, "batch": 32}),
    }


def recsys_shapes() -> dict[str, ShapeSpec]:
    """The reference's recsys shapes: ``serve_p99`` and ``serve_bulk`` (a
    forward over the batch), ``retrieval_cand`` (one user against 10⁶
    candidates; ``chip_smoke.py``'s recsys phase runs all three) and
    ``train_batch`` (``launch.train``'s recsys loop and ``chip_smoke.py``'s
recsys_train phase)."""
    return {
        "train_batch": ShapeSpec("train_batch", "train", {"batch": 65536}),
        "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                    {"batch": 1, "n_candidates": 1_000_000}),
    }
