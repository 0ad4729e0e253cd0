"""δ-EMG core on PyTorch — the counterpart of ``repro.core``.

Index containers:  GraphIndex, RaBitQCodes, EMQGIndex
Construction:      build_exact (Alg. 2), build_approx (Alg. 4), build_emqg
                   (Sec. 6.1), from_graph, baselines.BUILDERS
Search:            search / greedy_search (Alg. 1) / error_bounded_search
                   (Alg. 3), probing_search / error_bounded_probing_search
                   (Alg. 5), ags_search — all on the lock-step beam engine;
                   filtered.filtered_search, mips.mips_search on top.
Maintenance:       updates.JournaledLiveIndex (live insert / delete /
                   consolidate, WAL + crash recovery), verify.audit
                   (graph-invariant auditor)
Theory probes:     local_optimum_mask, theorem4_delta_prime
"""

from .types import (  # noqa: F401
    INVALID_ID,
    EMQGIndex,
    GraphIndex,
    RaBitQCodes,
    SearchParams,
    SearchResult,
)
from .build_exact import build_exact  # noqa: F401
from .build_approx import BuildParams, build_approx  # noqa: F401
from .emqg import build_emqg, from_graph, memory_footprint  # noqa: F401
from .search import (  # noqa: F401
    error_bounded_search,
    greedy_search,
    local_optimum_mask,
    make_batch_dist_fn,
    search,
    theorem4_delta_prime,
)
from .probing import (  # noqa: F401
    ags_search,
    error_bounded_probing_search,
    probing_search,
)
from . import baselines, bitset, distances, geometry, rabitq  # noqa: F401
from . import filtered, mips, updates, verify  # noqa: F401
