"""The port's models: the dense and MoE decoder-only LM (``transformer``,
``moe``), the recsys models FM, DCN-v2, DIEN and MIND (``recsys``), the
graph attention network (``gnn``) and their building blocks
(``common``)."""
