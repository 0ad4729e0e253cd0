"""Arch / shape registry of the port: the counterpart of
``repro.configs.base`` (``ShapeSpec``, ``ArchSpec``, ``register``,
``get_arch``, ``all_archs``, ``load_all`` and the shared shape sets
``lm_shapes`` and ``recsys_shapes``), holding every arch of the
reference with the same ids, families and shapes.

``family`` ("lm", "recsys", "gnn", "ann") says which of
``launch.train``'s loops trains an arch; "ann" (sift1m, the paper's own
configuration) has nothing to train and is served
(``launch.steps.ann_serve``).  ``skip`` marks a shape that is not
runnable for the arch, with the reason.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                   # train | prefill | decode | serve |
    #                             retrieval | full_graph | minibatch |
    #                             molecule | ann_serve
    dims: dict                  # family-specific dimensions
    skip: Optional[str] = None  # reason string → shape not runnable
    accum_steps: int = 1        # microbatch accumulation for train kinds


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str                 # lm | recsys | gnn | ann
    model_cfg: Any              # the family's config (dataclass or dict)
    shapes: dict[str, ShapeSpec]
    source: str = ""            # provenance note
    smoke_cfg: Any = None       # reduced config for CPU tests


_ARCH_MODULES = [
    "moonshot_v1_16b_a3b",
    "llama4_maverick_400b_a17b",
    "internlm2_20b",
    "phi3_mini_3_8b",
    "smollm_135m",
    "gat_cora",
    "mind",
    "dien",
    "fm",
    "dcn_v2",
    "sift1m",
]

_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> list[ArchSpec]:
    load_all()
    return list(_REGISTRY.values())


def load_all() -> None:
    """Import every arch's module (each registers its arch once)."""
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def lm_shapes(*, sub_quadratic: bool,
              accum_train: int = 8) -> dict[str, ShapeSpec]:
    """The reference's four LM shapes: ``train_4k`` (``launch.train`` and
    ``chip_smoke.py``'s train phase, the batch cut to what one card holds)
    with the arch's microbatch accumulation, ``prefill_32k``
    (``chip_smoke.py``'s prefill, its batch cut to 1), and the decode
    shapes ``decode_32k`` and ``long_500k``, which no port path runs yet
    (``decode_32k``'s batch of 128 does not fit one card: smollm's bf16 KV
    cache alone is ≈ 97 GB).  ``long_500k`` is skipped for an arch whose
    attention is full, as in the reference."""
    skip = (None if sub_quadratic else
            "pure full-attention arch — long_500k needs sub-quadratic "
            "attention (DESIGN.md §Shape-cell notes)")
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              {"seq": 4096, "batch": 256},
                              accum_steps=accum_train),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                {"seq": 32768, "batch": 128}),
        "long_500k": ShapeSpec("long_500k", "decode",
                               {"seq": 524288, "batch": 1}, skip=skip),
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
