from .faults import (  # noqa: F401
    FaultPlan,
    KernelFault,
    SimulatedCrash,
    crash_at,
    flip_bits,
    inject_search_faults,
    make_torn_tmp,
    tamper_array,
    tear_checkpoint,
    torn_wal_record,
)
