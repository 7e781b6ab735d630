"""Carry an index's host state from the JAX package into the port.

``from_jax_state`` takes what a ``spfresh_tpu`` ``SpannIndex`` holds on the
host — its ``postings`` dict (cluster id -> (ids, vectors)), its
``centroids`` dict, ``dim`` and ``config.to_dict()``, all numpy — and
returns an equivalent port ``SpannIndex`` on ``device``.  Nothing here
imports ``jax``: the caller hands over plain arrays.  Together with the
format-compatible ``save``/``load`` this lets both packages search the same
index.  Every storage dtype carries over: the slab view, int8 codes and
scales included, is a pure function of the postings and centroids, and the
port packs it as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from spfresh_tpu_torch.core.device import DEFAULT_DEVICE
from spfresh_tpu_torch.index.config import Config
from spfresh_tpu_torch.index.spann import SpannIndex


def from_jax_state(
    postings: Mapping[int, Tuple[Any, Any]],
    centroids: Mapping[int, Any],
    dim: int,
    config: Dict[str, Any],
    device: torch.device | str = DEFAULT_DEVICE,
) -> SpannIndex:
    """A port ``SpannIndex`` holding the given posting state."""
    if set(postings) != set(centroids):
        raise ValueError("postings and centroids must name the same cluster ids")
    index = SpannIndex(Config.from_dict(config), device=device)
    index.dim = int(dim)
    for cid in sorted(postings):
        ids, vecs = postings[cid]
        ids = np.asarray(ids, np.int64)
        index.postings[int(cid)] = (ids, np.asarray(vecs, np.float32).reshape(len(ids), int(dim)))
        index.centroids[int(cid)] = np.asarray(centroids[cid], np.float32).reshape(int(dim))
    index._next_cluster_id = max((int(c) + 1 for c in postings), default=0)
    index._gen += 1
    return index
