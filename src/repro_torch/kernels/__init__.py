"""Hand-written CUDA kernels for the ANN distance hot path (``sm_90a``).

    l2dist/  — fused gather + squared L2 (exact tier): ``gather_l2`` and
               ``gather_l2_tiled``, from ``csrc/gather_l2.cu``
    bitdot/  — packed 1-bit RaBitQ S₊ contraction (approximate tier), from
               ``csrc/bitdot.cu``

Each has ``ops.py`` (the wrapper: checks, launch count, CUDA launch or the
plain version on a CPU tensor) and ``ref.py`` (the plain PyTorch version).
``_build.py`` compiles the sources with ``nvcc`` at first use.
"""
