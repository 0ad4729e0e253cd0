"""δ-EMG core on PyTorch — the counterpart of ``repro.core``.

Index containers:  GraphIndex, RaBitQCodes, EMQGIndex
Construction:      build_approx (Alg. 4), build_emqg (Sec. 6.1), from_graph
Search:            search / greedy_search (Alg. 1) / error_bounded_search
                   (Alg. 3), probing_search / error_bounded_probing_search
                   (Alg. 5), ags_search — all on the lock-step beam engine.
"""

from .types import (  # noqa: F401
    INVALID_ID,
    EMQGIndex,
    GraphIndex,
    RaBitQCodes,
    SearchParams,
    SearchResult,
)
from .build_approx import BuildParams, build_approx  # noqa: F401
from .emqg import build_emqg, from_graph, memory_footprint  # noqa: F401
from .search import (  # noqa: F401
    error_bounded_search,
    greedy_search,
    make_batch_dist_fn,
    search,
)
from .probing import (  # noqa: F401
    ags_search,
    error_bounded_probing_search,
    probing_search,
)
from . import bitset, distances, geometry, rabitq  # noqa: F401
