"""The device an entry point runs on.

Every entry point of the port (``SpannIndexBuilder``, ``SpannIndex``,
``brute_force_search``, ``HierarchicalClustering``, ``from_jax_state``,
``PhaseTimer``) takes ``device``, default ``"cuda"``.  A caller that wants
the CPU (the tests) passes ``device="cpu"``.  Asking for CUDA where there is
no card raises at construction: nothing falls back to the CPU.
"""

from __future__ import annotations

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
