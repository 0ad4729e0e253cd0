from .synthetic import (  # noqa: F401
    MarkovLM,
    clustered_vectors,
    lm_batch,
    make_markov_lm,
)
