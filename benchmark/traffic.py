"""The general generator of the benchmark's traffic.  A traffic mix is a
data file, ``traffic/<name>.json``:

  params    Params keys set for every realization of the mix (the engine
            choice ``ooc``, a storage type, ...), over the configuration's

Realizations arrive back to back: the next starts when the last one has been
joined and dropped (a closed loop of one client, as an ensemble of
realizations runs on one card), each through the entry with its hand-off
overlapped (the entries' default).

Every realization gets a seed of its own, drawn from the run's --seed; the
realization whose products the check compares is drawn from the same seed,
uniformly among those the window completes (a reservoir of one), so that no
realization of the window can be wrong unseen.
"""

from __future__ import annotations

import numpy as np


class Generator:
    def __init__(self, seed: int):
        ss = np.random.SeedSequence(int(seed))
        seeds_ss, pick_ss = ss.spawn(2)
        self._seeds = np.random.Generator(np.random.PCG64(seeds_ss))
        self._pick = np.random.Generator(np.random.PCG64(pick_ss))
        self._warm = self._draw()

    def _draw(self) -> int:
        # the program keys its generator with the low 32 bits of a seed
        return int(self._seeds.integers(1, 2 ** 31 - 1))

    def warm_seed(self) -> int:
        return self._warm

    def next_seed(self) -> int:
        return self._draw()

    def sample(self, i: int) -> bool:
        """Whether the i-th realization (1-based) replaces the one kept
        for the check: with probability 1/i, so that the kept one is
        uniform over those completed."""
        return bool(self._pick.random() * i < 1.0)
