"""δ-EMG / δ-EMQG on PyTorch and CUDA — the port of the JAX package
``repro`` to an NVIDIA H100.

It imports ``torch`` and ``numpy`` and nothing of ``jax`` or ``repro``.
Entry points (``build_emqg``, ``build_approx``, ``interop.index_from_numpy``,
``serve.AnnServer``'s index, ``launch.serve --device``) default to
``device="cuda"`` and raise without a card unless given ``device="cpu"``.
The hot-path kernels are hand-written CUDA (``kernels/csrc``), built with
``nvcc`` at first use.
"""
