"""Arch / shape registry of the port: a copy of the part of
``repro.configs.base`` that the ported models use (``ShapeSpec``,
``ArchSpec``, ``lm_shapes``, ``register``, ``get_arch``), with only the
fields and shapes that a port path reads.

An arch's module is listed in ``_ARCH_MODULES`` once its model is ported:
smollm-135m came with the LM slice, the other four LM archs with the MoE
slice; the recsys and GNN archs come with the slices that port their
models.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                   # train | prefill (the kinds port paths run)
    dims: dict                  # family-specific dimensions
    accum_steps: int = 1        # microbatch accumulation for train kinds


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
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
