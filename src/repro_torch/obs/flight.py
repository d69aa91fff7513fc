"""Flight recorder: a bounded ring buffer of recent serving events.

In the spirit of the plan auditor's arena bounds, the recorder's memory
footprint is fixed at construction (``deque(maxlen=capacity)``): events
past capacity evict the oldest, never grow the buffer.  The ring absorbs
span/fault/breaker/retry/terminal events from the tracer; on one of the
dump triggers —

* ``flush_error``   — a whole batch failed (the scheduler's FlushError),
* ``breaker_open``  — a circuit breaker tripped open,
* ``slo_miss_burst``— >= ``slo_burst_n`` misses inside
  ``slo_burst_window_s`` seconds,

— the last ``capacity`` events are dumped as JSON to
``results/flightrec.json`` so a chaos-bench failure becomes a
postmortem-debuggable artifact instead of a counter increment.  Dumps are
rate-limited (``min_dump_interval_s``, measured on the injected clock's
timeline) so a fault storm produces one postmortem, not thousands.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "DEFAULT_PATH"]

DEFAULT_PATH = os.path.join("results", "flightrec.json")


class FlightRecorder:
    def __init__(self, capacity: int = 2048, *,
                 path: str = DEFAULT_PATH,
                 min_dump_interval_s: float = 1.0,
                 slo_burst_n: int = 8,
                 slo_burst_window_s: float = 1.0):
        self.capacity = capacity
        self.path = path
        self.min_dump_interval_s = min_dump_interval_s
        self.slo_burst_n = slo_burst_n
        self.slo_burst_window_s = slo_burst_window_s
        self._ring: deque = deque(maxlen=capacity)
        self._miss_t: deque = deque(maxlen=max(1, slo_burst_n))
        self._last_dump_t: Optional[float] = None
        self.recorded = 0       # total events ever offered to the ring
        self.dumps = 0          # dumps actually written
        self.suppressed = 0     # triggers swallowed by rate limiting
        self.last_dump_path: Optional[str] = None
        self.last_dump_reason: Optional[str] = None
        # time.time_ns() less the events' clock in ns, set by the Tracer
        # that records here (None: unknown, or a virtual clock)
        self.clock_offset_ns: Optional[int] = None

    # -- recording --------------------------------------------------------

    def record(self, kind: str, t: float, **fields: Any) -> None:
        """Append one event; O(1), evicts the oldest past capacity."""
        self._ring.append({"kind": kind, "t": t, **fields})
        self.recorded += 1

    def note_slo_miss(self, t: float) -> None:
        """Track an SLO miss; a burst of ``slo_burst_n`` misses inside the
        window triggers a dump."""
        self._miss_t.append(t)
        if (len(self._miss_t) == self._miss_t.maxlen
                and t - self._miss_t[0] <= self.slo_burst_window_s):
            self.trigger("slo_miss_burst", t)

    @property
    def dropped(self) -> int:
        """Events evicted from the ring since construction."""
        return self.recorded - len(self._ring)

    def events(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    # -- dumping ----------------------------------------------------------

    def trigger(self, reason: str, t: float) -> Optional[str]:
        """Rate-limited dump; returns the path written, or None when the
        trigger fell inside the rate-limit window."""
        if (self._last_dump_t is not None
                and t - self._last_dump_t < self.min_dump_interval_s):
            self.suppressed += 1
            return None
        return self.dump(reason, t)

    def dump(self, reason: str, t: float,
             path: Optional[str] = None) -> str:
        """Unconditionally write the ring to ``path`` as JSON."""
        path = path or self.path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        doc = {"reason": reason, "t": t,
               "capacity": self.capacity,
               "recorded": self.recorded, "dropped": self.dropped,
               "clock_offset_ns": self.clock_offset_ns,
               "events": self.events()}
        with open(path, "w") as f:
            # default=repr: span attrs may carry numpy scalars etc. — a
            # postmortem must never fail to serialize
            json.dump(doc, f, indent=1, default=repr)
            f.write("\n")
        self._last_dump_t = t
        self.dumps += 1
        self.last_dump_path = path
        self.last_dump_reason = reason
        return path

    def status(self) -> Dict[str, Any]:
        return {"capacity": self.capacity, "buffered": len(self._ring),
                "recorded": self.recorded, "dropped": self.dropped,
                "dumps": self.dumps, "suppressed": self.suppressed,
                "last_dump_path": self.last_dump_path,
                "last_dump_reason": self.last_dump_reason}
