"""Kernel launch counts that hold under CUDA-graph replay.

Each kernel wrapper carries a plain integer ``<wrapper>.launches`` and calls
:func:`note` where it launches its kernel.  A launch made eagerly adds one to
the wrapper's count.  A launch made while this thread records (warm-up runs
and the capture of a CUDA graph, under :func:`recording`) goes to the
recording's tally instead: a captured graph makes no Python call when it is
replayed, so its owner records the tally once at capture and adds it to the
counts with :func:`replayed` on every replay.  The counts then say how often
the device ran each kernel, whichever way it was launched.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter

_LOCAL = threading.local()      # this thread's recording tally, if any
_COUNTS_LOCK = threading.Lock()  # the wrappers' counts are shared by threads


def note(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: into this thread's recording
    tally while one is open, else onto ``wrapper.launches``."""
    tally = getattr(_LOCAL, "tally", None)
    if tally is not None:
        tally[wrapper] += 1
        return
    with _COUNTS_LOCK:
        wrapper.launches += 1


def recording_tally() -> Counter | None:
    """The tally this thread records into (``None`` when not recording)."""
    return getattr(_LOCAL, "tally", None)


@contextlib.contextmanager
def recording():
    """Record this thread's launches into a fresh ``Counter`` (wrapper →
    launches) instead of counting them; yields the tally."""
    prev = getattr(_LOCAL, "tally", None)
    tally: Counter = Counter()
    _LOCAL.tally = tally
    try:
        yield tally
    finally:
        _LOCAL.tally = prev


def replayed(tally: Counter) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    with _COUNTS_LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n
