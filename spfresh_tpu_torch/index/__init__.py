from spfresh_tpu_torch.index.builder import SpannIndexBuilder
from spfresh_tpu_torch.index.config import Config, SearchConfig
from spfresh_tpu_torch.index.posting_store import (
    FileBasedPostingListStore,
    PointData,
    PostingListStore,
    read_packed_postings,
    write_packed_postings,
)
from spfresh_tpu_torch.index.lazy import LazySpannIndex
from spfresh_tpu_torch.index.spann import SpannIndex, brute_force_search

__all__ = [
    "Config",
    "SearchConfig",
    "FileBasedPostingListStore",
    "PointData",
    "PostingListStore",
    "LazySpannIndex",
    "SpannIndex",
    "SpannIndexBuilder",
    "brute_force_search",
    "read_packed_postings",
    "write_packed_postings",
]
