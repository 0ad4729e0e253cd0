from .oracle import check_delta_bound, exact_knn, recall_at_k  # noqa: F401
from .compare import indexes_equal  # noqa: F401
from .faults import (  # noqa: F401
    FaultPlan,
    KernelFault,
    RepairFault,
    RepairFaultPlan,
    ShardDeathPlan,
    SimulatedCrash,
    corrupt_shard_source,
    crash_at,
    flip_bits,
    inject_search_faults,
    inject_shard_deaths,
    make_torn_tmp,
    tamper_array,
    tear_checkpoint,
    torn_wal_record,
)
