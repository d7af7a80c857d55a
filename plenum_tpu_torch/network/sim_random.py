"""Seeded deterministic randomness for protocol simulation.

Reference behavior: plenum/test/simulation/sim_random.py — every random choice
in a simulated pool flows through one seeded source so a failing fuzz run can
be replayed exactly from its seed (SURVEY.md §4 item 3).
"""
from __future__ import annotations

import random
from typing import Any, Sequence


class SimRandom:
    def __init__(self, seed: int = 42):
        self._seed = seed
        self._rng = random.Random(seed)

    @property
    def seed(self) -> int:
        return self._seed

    def integer(self, low: int, high: int) -> int:
        """Uniform integer in [low, high]."""
        return self._rng.randint(low, high)

    def float(self, low: float, high: float) -> float:
        return self._rng.uniform(low, high)

    def string(self, length: int, alphabet: str = "abcdefghijklmnopqrstuvwxyz") -> str:
        return "".join(self._rng.choice(alphabet) for _ in range(length))

    def choice(self, *args: Any) -> Any:
        return self._rng.choice(args if len(args) > 1 else args[0])

    def sample(self, population: Sequence, k: int) -> list:
        return self._rng.sample(list(population), k)

    def shuffle(self, items: Sequence) -> list:
        out = list(items)
        self._rng.shuffle(out)
        return out
