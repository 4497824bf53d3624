"""The seeded key schedule a scripted player holds, tick by tick.

The traffic file lists one ``cycle`` of segments, each ``{"keys": [...],
"ticks": [n, ...]}``: the keys held (one key or a pair; none rests the
camera, so TAA accumulates history) and the lengths in ticks they are held
for. Every (keys, length) pair is one segment of the cycle. A segment that
holds keys is followed by the ``opposite`` keys (W/S, A/D, E/Q and the
arrows) for as long, so the pose comes back to where the segment started
and the camera stays in the part of the scene its start pose frames. The
schedule repeats the cycle, each repetition in an order drawn from
``--seed``: every seed holds the same segments, so a cycle does the same
work whatever the seed, and a seed decides which parts of the scene a
short window sees.

Lengths are multiples of the largest batch a traffic file uses, so a
batched loop, which samples the keys once a batch, replays every segment
as often as the unbatched loop. The traffic file bounds the excursions
through its lengths: a held arrow of ``n`` ticks turns the camera by
``n * 1.6 * dt`` radians, a held move key moves it ``n * 3 * dt`` units.
"""

from __future__ import annotations

from typing import FrozenSet, List, Tuple

import numpy as np


def segments(traffic: dict) -> List[Tuple[FrozenSet[str], int]]:
    """Every (held keys, ticks) segment of one cycle, in file order."""
    return [(frozenset(seg["keys"]), int(n))
            for seg in traffic["cycle"] for n in seg["ticks"]]


class KeySchedule:
    def __init__(self, traffic: dict, seed: int):
        self._segments = segments(traffic)
        self._opposite = traffic["opposite"]
        self._rng = np.random.default_rng(seed)
        self._ticks: List[FrozenSet[str]] = []

    def _repeat(self) -> None:
        for i in self._rng.permutation(len(self._segments)):
            held, n = self._segments[int(i)]
            self._ticks += [held] * n
            if held:
                back = frozenset(self._opposite[k] for k in held)
                self._ticks += [back] * n

    def keys_at(self, tick: int) -> FrozenSet[str]:
        while len(self._ticks) <= tick:
            self._repeat()
        return self._ticks[tick]


class ScriptedInput:
    """The ``engine/input.py`` surface the shell's components read:
    ``is_key_down`` answers from the schedule at the current tick."""

    def __init__(self, schedule: KeySchedule):
        self.schedule = schedule
        self.tick = 0

    def is_key_down(self, key: str) -> bool:
        return key in self.schedule.keys_at(self.tick)
