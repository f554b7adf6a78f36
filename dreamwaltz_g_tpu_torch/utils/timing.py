"""Named spans of host and device time.

``span(name, device)`` is a ``torch.profiler.record_function`` range, so a
profile shows it by name. While ``enabled`` is true it also times the span:
the host's ``perf_counter`` interval and, on the card, a CUDA event at each
end on the current stream (recorded without waiting for the card), kept in
``records[name]``. ``times(name)`` synchronizes and returns each span's
(device ms, host ms). Off, a span costs one range.

The trainer marks the stage-1 export and the avatar's initialisation with
spans, and ``system/avatar.py`` the LBS weights' KNN smoothing.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

enabled = False
records: Dict[str, List[Tuple[Optional[list], float]]] = {}


@contextlib.contextmanager
def span(name: str, device=None):
    with record_function(name):
        if not enabled:
            yield
            return
        events = None
        if device is not None and torch.device(device).type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host_ms = (time.perf_counter() - t0) * 1e3
            if events is not None:
                events[1].record()
            records.setdefault(name, []).append((events, host_ms))


def times(name: str) -> List[Tuple[Optional[float], float]]:
    """Each recorded span of ``name``: (device ms between its events, None
    off the card; host ms)."""
    recs = records.get(name, [])
    if any(ev is not None for ev, _ in recs):
        torch.cuda.synchronize()
    return [(None if ev is None else ev[0].elapsed_time(ev[1]), ms)
            for ev, ms in recs]
