"""Launch counts that follow what the card runs, CUDA graphs included.

A kernel wrapper calls :func:`count` where it launches its kernel. Off a
stream capture that adds one to the count at once. During a capture the
kernel does not run: the launch is recorded on the innermost
:func:`recording` tally instead, and the graph's owner adds the tally at
each replay (:meth:`Tally.replayed`), since a replay runs every launch
the graph captured. A launch captured with no tally open raises: its
replays could not be counted.

Inside ``launch.census`` (:func:`census`) the program runs on fake
tensors: a wrapper that meets one (:func:`fake`) makes outputs of the
right shape, launches nothing and counts its launch on the census's
tally, never on the process's counts. The open census also says which
device type it counts on (:func:`census_stand`), which
``device.resolve_device`` reads.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

_OPEN: List["Tally"] = []  # the tallies of the captures in progress
# the censuses in progress: each one's tally and the device type it
# counts on ("cuda", "meta" standing for the card, or "cpu")
_CENSUS: List[Tuple["Tally", str]] = []


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
    or, during a capture, on the open tally; during a census on the
    census's tally."""
    if _CENSUS:
        _CENSUS[-1][0].add(table, key)
        return
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


@contextlib.contextmanager
def census(stand: str):
    """``launch.census``'s block, counting on device type ``stand``
    ("cuda", "meta" standing for the card, or "cpu"): the launches within
    it go on a new ``Tally`` (yielded) and on no process count."""
    record = (Tally(), stand)
    _CENSUS.append(record)
    try:
        yield record[0]
    finally:
        _CENSUS.remove(record)


def census_stand() -> Optional[str]:
    """The device type the innermost open census counts on, None outside
    a census."""
    return _CENSUS[-1][1] if _CENSUS else None


def fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor of a census of the card path (on
    CUDA, or on the meta device that stands for it): its wrapper takes
    the card's route, counts the launch and launches nothing."""
    from torch._subclasses.fake_tensor import is_fake

    stand = census_stand()
    return stand in ("cuda", "meta") and t.device.type == stand and is_fake(t)
