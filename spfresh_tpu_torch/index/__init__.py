from spfresh_tpu_torch.index.builder import SpannIndexBuilder
from spfresh_tpu_torch.index.config import Config, SearchConfig
from spfresh_tpu_torch.index.lazy import LazySpannIndex
from spfresh_tpu_torch.index.spann import SpannIndex, brute_force_search

__all__ = ["Config", "LazySpannIndex", "SearchConfig", "SpannIndex", "SpannIndexBuilder",
           "brute_force_search"]
