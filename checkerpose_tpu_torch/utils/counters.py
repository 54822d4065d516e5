"""One reset for every launch counter of the port.

A module that counts its kernels' launches registers a function that zeroes
its own counts; `reset_launch_counts()` calls each registered one. The
EdgeConv op (`ops/edgeconv.py`) and the solver (`solver/fused.py`) register
theirs when they are imported, so the reset reaches every counter there is,
and neither layer imports the other.
"""
from __future__ import annotations

from typing import Callable, List

_RESETS: List[Callable[[], None]] = []


def register(reset: Callable[[], None]) -> Callable[[], None]:
    """Add `reset` to the functions `reset_launch_counts` calls, call it once
    (so the counts exist from the import on) and return it."""
    _RESETS.append(reset)
    reset()
    return reset


def reset_launch_counts():
    """Zero the launch counts of every module that registered its reset."""
    for reset in _RESETS:
        reset()
