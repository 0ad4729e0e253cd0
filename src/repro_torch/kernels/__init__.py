"""Hand-written CUDA kernels for the ANN distance hot path and the LM's
attention (``sm_90a``).

    l2dist/  — fused gather + squared L2 (exact tier): ``gather_l2`` (one
               row a warp) and ``gather_l2_tiled`` (several), from
               ``csrc/gather_l2.cu`` on the register row body of
               ``csrc/l2_rows.cuh``; and
               ``batched_l2`` (row tiles against one query line each: the
               builders' occlusion test), from ``csrc/batched_l2.cu``
    bitdot/  — packed 1-bit RaBitQ S₊ contraction, from ``csrc/bitdot.cu``;
               and ``fused_estimate`` (the whole RaBitQ estimate, gathered
               by id: the approximate tier), from ``csrc/fused_estimate.cu``
    flashattn/ — causal / sliding-window flash-attention forward with
               grouped KV heads (the LM's attention): bf16 on the tensor
               cores from ``csrc/flash_attn_sm90.cu`` (wgmma, TMA; its
               PTX wrappers in ``csrc/sm90_ptx.cuh``), float32 on the CUDA
               cores from ``csrc/flash_attn.cu``
    topc/    — the merge of a sorted top-C candidate buffer with a pass's
               new entries, in place (the search loops'
               ``batch_merge_topc``), from ``csrc/merge_topc.cu``

Each has ``ops.py`` (the wrapper: checks, launch count, CUDA launch or the
plain version on a CPU tensor) and ``ref.py`` (the plain PyTorch version).
``_build.py`` compiles the sources with ``nvcc`` at first use.
"""
