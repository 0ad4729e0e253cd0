from .sampler import CSRGraph, fanout_sample  # noqa: F401
from .synthetic import (  # noqa: F401
    MarkovLM,
    clustered_vectors,
    lm_batch,
    make_markov_lm,
    molecule_batch,
    recsys_ctr_batch,
    recsys_seq_batch,
    sbm_graph,
)
