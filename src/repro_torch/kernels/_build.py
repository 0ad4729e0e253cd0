"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone with
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` under the
checkout's root (``.gitignore`` lists ``build/``).  The hash is the
source's content hash, so an edited source is rebuilt and a stale library
is never loaded.  ``build_all`` starts one ``nvcc`` per source, all at once.

A missing ``nvcc`` or a failed compile raises with the compiler's output;
nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gather_l2", "bitdot", "fused_estimate", "batched_l2",
           "flash_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
        os.replace(tmp, out)
    return [name for name, *_ in started]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a non-zero ``cudaGetLastError``."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
