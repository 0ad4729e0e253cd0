"""The port's models: the dense and MoE decoder-only LM (``transformer``,
``moe``), the recsys models FM, DCN-v2, DIEN and MIND (``recsys``) and
their building blocks (``common``).  GNN models come with a later
slice."""
