"""
Lightweight phase profiling for the coaddition pipeline.

The port's copy of ``pyimcom_tpu/profiling.py`` (``enabled``, ``phase``,
``reset``, ``report``), so that the port imports nothing of the JAX
package; its ``sync`` waits on JAX arrays and is not copied.  Every hot
phase of the block driver is bracketed with :func:`phase` context managers;
accumulated wall-clock per phase is printed at the end of a block run when
``PYIMCOM_PROFILE=1``.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

_ACC: dict[str, float] = defaultdict(float)
_CNT: dict[str, int] = defaultdict(int)


def enabled() -> bool:
    return os.environ.get("PYIMCOM_PROFILE", "0") == "1"


@contextmanager
def phase(name: str):
    """Accumulate wall time under `name` (no-op overhead when disabled)."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACC[name] += time.perf_counter() - t0
        _CNT[name] += 1


def reset():
    _ACC.clear()
    _CNT.clear()


def report(header: str = "profile"):
    if not enabled() or not _ACC:
        return
    total = sum(_ACC.values())
    print(f"[{header}] phase timings (total bracketed {total:.2f} s):", flush=True)
    for name, t in sorted(_ACC.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<28s} {t:9.3f} s  x{_CNT[name]}", flush=True)
