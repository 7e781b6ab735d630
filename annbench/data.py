"""Inputs made from the run's seed: the corpus, the query pool, the vectors
the writer inserts, the order it deletes in, and the traffic's draws.

Each input comes from its own stream, a generator seeded from (seed, the
stream's name), so adding a stream changes no other.  Vectors are drawn on
the run's device with a ``torch.Generator`` there, in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = ("centers", "corpus", "queries", "inserts", "deletes", "traffic", "sample", "probes")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run with ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, STREAMS.index(stream)])
    hi, lo = ss.generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & (2**63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def host_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


class Mixture:
    """bench.py's SIFT-like corpus model: a Gaussian mixture of
    max(min_centers, n // points_per_center) unit-normal centers, each point
    a center plus ``spread`` times unit-normal noise; queries and inserts
    come from the same mixture.

    The deployment's data is the same for every run, as a data set is: the
    centers and the corpus come from the configuration's ``data_seed``, so
    every seed builds and serves the same index.  Queries and inserts are
    fresh draws from the run's seed."""

    def __init__(self, corpus: dict, seed: int, device):
        self.seed, self.device = seed, torch.device(device)
        self.data_seed = int(corpus["data_seed"])
        self.n, self.dim, self.spread = corpus["n"], corpus["dim"], corpus["spread"]
        n_centers = max(corpus["min_centers"], self.n // corpus["points_per_center"])
        g = generator(self.data_seed, "centers", self.device)
        self.centers = torch.randn((n_centers, self.dim), generator=g, device=self.device)

    def draw(self, m: int, stream: str, seed: int | None = None) -> torch.Tensor:
        """``m`` points of the mixture from ``stream`` of ``seed`` (the run's
        by default): (m, dim) f32."""
        g = generator(self.seed if seed is None else seed, stream, self.device)
        a = torch.randint(0, self.centers.shape[0], (m,), generator=g, device=self.device)
        noise = torch.randn((m, self.dim), generator=g, device=self.device)
        return self.centers[a] + self.spread * noise

    def corpus(self) -> torch.Tensor:
        """The deployment's ``n`` rows."""
        return self.draw(self.n, "corpus", self.data_seed)


GENERATORS = {"mixture": Mixture}


def make_corpus(config: dict, seed: int, device):
    """The corpus model a configuration names."""
    corpus = config["corpus"]
    return GENERATORS[corpus["generator"]](corpus, seed, device)
