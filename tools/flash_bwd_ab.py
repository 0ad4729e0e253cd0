#!/usr/bin/env python3
"""Time the bf16 attention backward (``csrc/flash_attn_bwd_sm90.cu``) of
this tree against other versions of its source, in one process on one
card, at ``chip_smoke.py``'s train shape and at moonshot's head dim.

    mkdir -p build/ab/x
    cp src/repro_torch/kernels/csrc/flash_attn_bwd_sm90.cu build/ab/x/
    # edit build/ab/x/flash_attn_bwd_sm90.cu (or a header copied beside it)
    python3 tools/flash_bwd_ab.py --variant x=build/ab/x

Each ``--variant TAG=DIR`` names a directory holding a
``flash_attn_bwd_sm90.cu`` with this tree's C interface (the headers it
includes resolve in DIR first, then in ``src/repro_torch/kernels/csrc``),
built with the port's own ``nvcc`` flags into ``build/ab/``.  At each
shape every library, this tree's (``tree``) first, runs from the forward
kernel's output and lse: held against ``attention_bwd_ref`` in f32
(``ref.grad_err_ratio`` of dq, dk and dv, and of dq's first row of each
sequence apart, whose exact value is 0) and to this tree's output to the
bit; timed in turns (a, b, …, b, a: CUDA events over 20 launches after
3); and profiled (each kernel's own device µs a launch, torch.profiler).
SDPA's backward through autograd is timed beside them.  One JSON line a
row goes to stdout and to ``build/flash_bwd_ab.jsonl``, after the card's
name and power limit; then each library's ptxas lines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
# (B, S, H, KV, hd): chip_smoke's train step, and moonshot's hd = 128
SHAPES = ((4, 4096, 9, 3, 64), (1, 4096, 16, 16, 128))
LIB = "flash_attn_bwd_sm90"


def build(variants: dict) -> dict:
    """{tag: (ctypes library, ptxas log)}, this tree's as ``tree``."""
    from repro_torch.kernels import _build

    _build.build_all((LIB,))
    libs = {"tree": (_build.load(LIB), _build.build_log(LIB))}
    procs = {}
    for tag, src in variants.items():
        out = ROOT / "build" / "ab" / f"{tag}_{LIB}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-I",
               str(_build.CSRC), "-o", str(out), str(Path(src) / f"{LIB}.cu")]
        procs[tag] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    for tag, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = (ctypes.CDLL(str(out)), log)
    return libs


def row_ratios(out, want):
    """``ref.grad_err_ratio``'s ratio of each [B, S, heads] row (the
    floor from the whole gradient's RMS, as there)."""
    from repro_torch.kernels.flashattn import ref

    want = want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    lim = (ref.BF16_REL * want.abs() + ref.BF16_ROW * rms
           + ref.GRAD_FLOOR * float(want.square().mean().sqrt()))
    return ((out.float() - want).abs() / lim.clamp_min(1e-30)).amax(-1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="TAG=DIR")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.flashattn import ops, ref

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build(dict(v.split("=", 1) for v in args.variant))
    load = _build.load

    def use(tag):
        _build.load = lambda name: libs[tag][0] if name == LIB else load(name)

    dev = torch.device("cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def event_ms(fn):
        for _ in range(3):
            fn()
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 20

    rows = []
    for B, S, H, KV, hd in SHAPES:
        g = torch.Generator(device=dev).manual_seed(2)
        q, k, v, do = [torch.randn((B, S, n, hd), generator=g, device=dev)
                       .bfloat16() for n in (H, KV, KV, H)]
        o, lse = ops.flash_attention(q, k, v, return_lse=True)
        want = ref.attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)))
        run = lambda: ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
        shape = f"q[{B},{S},{H},{hd}] kv[{B},{S},{KV},{hd}] bf16 causal"
        first = None
        for tag in libs:
            use(tag)
            got = run()
            first = first or got
            ratios = [ref.grad_err_ratio(a, w) for a, w in zip(got, want)]
            dq_rows = row_ratios(got[0], want[0])
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            kernels = {re.search(r"bwd_\w+", e.key).group(0):
                       e.device_time_total / 5 for e in prof.key_averages()
                       if re.search(r"bwd_\w+", e.key)}
            rows.append(dict(
                tag=tag, shape=shape, ratios=ratios,
                dq_row0=float(dq_rows[:, 0].max()),
                dq_rows1=float(dq_rows[:, 1:].max()),
                bitwise=all(torch.equal(a, b) for a, b in zip(got, first)),
                kernel_us=kernels, ms=[]))
        del want
        mine = rows[-len(libs):]
        for r in mine + mine[::-1]:
            use(r["tag"])
            r["ms"].append(event_ms(run))
        leaves = [x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v)]
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                     enable_gqa=True)
            sdpa_ms = event_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do.transpose(1, 2), retain_graph=True))
        for r in mine:
            r.update(sdpa_ms=sdpa_ms, card=card)
        del q, k, v, o, do, lse, leaves, lib_out, first
        torch.cuda.empty_cache()
    _build.load = load
    out = ROOT / "build" / "flash_bwd_ab.jsonl"
    with open(out, "w") as f:
        for r in rows:
            print(json.dumps(r))
            f.write(json.dumps(r) + "\n")
    for tag, (_, log) in libs.items():
        keep = [ln.strip() for ln in log.splitlines()
                if "bwd_" in ln or "Used" in ln or "spill" in ln]
        print(f"[ptxas] {tag}: " + " | ".join(keep))


if __name__ == "__main__":
    main()
