"""The port's models: the dense decoder-only LM (``transformer``) and its
building blocks (``common``).  MoE, recsys and GNN models come with later
slices."""
