"""Per-iteration statistics containers (reference: cuda_graph_optimisation.h:46-107)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BatchInfo:
    iteration: int
    chi2: float


class BatchStatistics:
    def __init__(self):
        self._stats: list[BatchInfo] = []

    def add_stat(self, stat: BatchInfo) -> None:
        self._stats.append(stat)

    def get(self) -> list[BatchInfo]:
        return self._stats

    def last(self) -> BatchInfo:
        return self._stats[-1]

    def clear(self) -> None:
        self._stats.clear()

    addStat = add_stat
