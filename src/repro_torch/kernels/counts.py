"""Launch counts that follow what the card runs, CUDA graphs included.

A kernel wrapper calls :func:`count` where it launches its kernel. Off a
stream capture that adds one to the count at once. During a capture the
kernel does not run: the launch is recorded on the innermost
:func:`recording` tally instead, and the graph's owner adds the tally at
each replay (:meth:`Tally.replayed`), since a replay runs every launch
the graph captured. A launch captured with no tally open raises: its
replays could not be counted.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

_OPEN: List["Tally"] = []  # the tallies of the captures in progress


class Tally:
    """The launches recorded during one capture, by count table and key."""

    def __init__(self):
        self._items: Dict[Tuple[int, object], list] = {}

    def add(self, table, key) -> None:
        item = self._items.setdefault((id(table), key), [table, key, 0])
        item[2] += 1

    def replayed(self, times: int = 1) -> None:
        """Add the recorded launches ``times`` times to their counts."""
        for table, key, n in self._items.values():
            table[key] += n * times

    def launches(self) -> Dict[object, int]:
        """The recorded launches by key."""
        out: Dict[object, int] = {}
        for _, key, n in self._items.values():
            out[key] = out.get(key, 0) + n
        return out


def count(table, key) -> None:
    """One launch of ``key``'s kernel on the current stream: counted now,
    or, during a capture, on the open tally."""
    if torch.cuda.is_current_stream_capturing():
        if not _OPEN:
            raise RuntimeError(
                f"{key}: launched during a CUDA graph capture with no launch "
                f"tally open; capture under kernels.counts.recording()")
        _OPEN[-1].add(table, key)
    else:
        table[key] += 1


@contextlib.contextmanager
def recording():
    """Record the launches captured within the block on a new ``Tally``
    (yielded)."""
    tally = Tally()
    _OPEN.append(tally)
    try:
        yield tally
    finally:
        _OPEN.remove(tally)
