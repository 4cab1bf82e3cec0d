"""Seeds of a run's independent streams, and uniform samples of a stream
of results, drawn from the run's seed."""

from __future__ import annotations

import numpy as np


def stream_seed(seed: int, k: int) -> int:
    """The seed of stream ``k`` of a run seeded ``seed`` (any whole
    number): independent streams, one per part of the traffic."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, make):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.n))
            if j < self.k:
                self.items[j] = make()
