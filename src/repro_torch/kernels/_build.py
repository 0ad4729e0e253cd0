"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone with
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` under the
checkout's root (``.gitignore`` lists ``build/``), with the compiler's
output beside it as ``<name>-<hash>.log``.  The hash covers the source,
every ``csrc`` header it includes (``#include "x.cuh"``, followed
through headers), and its flags, so an edited source or header is rebuilt
and a stale library is never loaded.  ``EXTRA_FLAGS`` gives a source flags
of its own.  ``build_all`` starts one ``nvcc`` per source, all at once.

A missing ``nvcc`` or a failed compile raises with the compiler's output;
nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gather_l2", "bitdot", "fused_estimate", "batched_l2",
           "flash_attn", "flash_attn_sm90", "flash_attn_bwd_sm90",
           "flash_attn_bwd_f32", "merge_topc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# flags of one source only: ptxas reports the registers, spills and shared
# memory of the tensor-core kernels (and any serialised wgmma), of the
# float32 attention backward, of the L2 kernels, of the RaBitQ kernels and
# of the merge into their build logs
EXTRA_FLAGS = {name: ("-Xptxas=-v",)
               for name in ("flash_attn_sm90", "flash_attn_bwd_sm90",
                            "flash_attn_bwd_f32", "gather_l2", "batched_l2",
                            "bitdot", "fused_estimate", "merge_topc")}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return found


def _headers(path: Path, seen: dict) -> dict:
    """The ``csrc`` headers ``path`` includes, directly or through other
    headers, as {name: bytes}."""
    for inc in _INCLUDE.findall(path.read_bytes()):
        header = CSRC / inc.decode()
        if header.name not in seen and header.exists():
            seen[header.name] = header.read_bytes()
            _headers(header, seen)
    return seen


def _flags(name: str) -> tuple:
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header, text in sorted(_headers(src, {}).items()):
        h.update(header.encode() + b"\0" + text)
    h.update("\0".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """The compiler's output of the library ``load(name)`` would load, or
    "" if it has not been built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, cmd, proc


def build_all(names=SOURCES) -> list[str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together, and return the names it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = [(n, *_start(n)) for n in names if not library_path(n).exists()]
    for name, out, tmp, cmd, proc in started:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                               f"{text}")
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    return [name for name, *_ in started]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


TENSOR_MAP_ERROR = 10000     # + the CUresult of a refused TMA tensor map


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a non-zero ``cudaGetLastError`` (or
    ``TENSOR_MAP_ERROR`` + the driver's ``CUresult`` for a tensor map)."""
    if rc >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: the driver "
                           f"refused a TMA tensor map, CUresult "
                           f"{rc - TENSOR_MAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
