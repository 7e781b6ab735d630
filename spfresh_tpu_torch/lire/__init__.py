"""LIRE / SPFresh in-place updates (counterpart of ``spfresh_tpu/lire/``):
``SpFreshIndex`` serves from the in-memory ``SpannIndex`` on its device
and keeps its durable state in ``LireStorage`` files, format-compatible
with the JAX package's.  The disk tier: ``LazySpFreshIndex`` serves the same
updates over a packed index on disk through ``index.LazySpannIndex``, with
its state in ``PackedLireStorage`` (packed base, RAM overlay, WAL), whose
files are byte-compatible with the JAX package's."""

from spfresh_tpu_torch.lire.fresh import SpFreshIndex
from spfresh_tpu_torch.lire.lazy_fresh import LazySpFreshIndex
from spfresh_tpu_torch.lire.packed_storage import PackedLireStorage
from spfresh_tpu_torch.lire.operations import (
    LireContext,
    LireOperationError,
    Merge,
    MergeError,
    OperationResult,
    PartitionOperation,
    Reassign,
    ReassignError,
    Split,
    SplitError,
)
from spfresh_tpu_torch.lire.pipeline import (
    PartitionStatus,
    PipelineError,
    TaskOutcome,
    TwoStagePipeline,
)
from spfresh_tpu_torch.lire.protocol import LireConfig, LireProtocol, UpdateResult
from spfresh_tpu_torch.lire.storage import LireStorage, LireStorageError, PostingMetadata

__all__ = [
    "LireConfig",
    "LireContext",
    "LireOperationError",
    "LireProtocol",
    "LireStorage",
    "LireStorageError",
    "LazySpFreshIndex",
    "PackedLireStorage",
    "Merge",
    "MergeError",
    "OperationResult",
    "PartitionOperation",
    "PartitionStatus",
    "PipelineError",
    "PostingMetadata",
    "Reassign",
    "SpFreshIndex",
    "Split",
    "SplitError",
    "ReassignError",
    "TaskOutcome",
    "TwoStagePipeline",
    "UpdateResult",
]
