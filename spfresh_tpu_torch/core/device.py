"""The device an entry point runs on.

Every entry point of the port (``SpannIndexBuilder``, ``SpannIndex``,
``brute_force_search``, ``HierarchicalClustering``, ``from_jax_state``,
``PhaseTimer``) takes ``device``, default ``"cuda"``.  The multi-device
ones (``ShardedSpannIndex``, the device-list build) take a list of
entries, each resolved by ``resolve_entry``.  A caller that wants
the CPU (the tests) passes ``device="cpu"``.  Asking for CUDA where there is
no card raises at construction: nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import List

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no card is
    available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_entry(device: torch.device | str) -> torch.device:
    """One entry of a device list: ``resolve_device``, with a bare
    ``"cuda"`` pinned to the current card's index, so that entries compare
    equal to the ``device`` of the tensors placed on them."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_entries(devices) -> List[torch.device]:
    """A device list, each entry resolved (an entry may repeat a device);
    raises when it is empty."""
    devs = [resolve_entry(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    return devs
