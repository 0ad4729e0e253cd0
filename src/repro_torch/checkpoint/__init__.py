from .manager import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointManager,
    list_steps,
    restore_latest,
    save_checkpoint,
)
