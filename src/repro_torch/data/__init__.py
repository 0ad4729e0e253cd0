from .synthetic import (  # noqa: F401
    MarkovLM,
    clustered_vectors,
    lm_batch,
    make_markov_lm,
    recsys_ctr_batch,
    recsys_seq_batch,
)
