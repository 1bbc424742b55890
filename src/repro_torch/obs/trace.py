"""Span/event tracing with Chrome trace-event JSON export (DESIGN.md §8).

The paper's core claim is a *schedule* — VEC/MXU/DMA streams overlapped
under a multi-tier tiling — so the repo needs a way to show timelines:
measured serving steps and request lifecycles on the host, and the
simulator's resolved task timeline, in the SAME format. ``Tracer``
records spans/instants/counters into a bounded ring buffer with a
monotonic clock and exports Chrome trace-event JSON, which opens
directly in ``chrome://tracing`` or https://ui.perfetto.dev.

Design rules:

* **Near-zero overhead when disabled.** Every recording method starts
  with the ``enabled`` guard; ``span()`` on a disabled tracer returns a
  shared no-op singleton — no allocation, no clock read, per call.
  ``NULL_TRACER`` is the module-level disabled instance the serving
  engines default to (like ``faults.NO_FAULTS``).
* **No globals required.** A ``Tracer`` is an explicit object threaded
  through; code under test creates its own (optionally with a fake
  clock) and engines take one as a constructor argument.
* **Bounded memory.** The ring buffer keeps the most recent
  ``max_events``; the export flags how many were dropped
  (``otherData.dropped_events`` plus a metadata instant), so a
  truncated trace can never masquerade as a complete one.
* **Virtual time supported.** ``complete()`` takes explicit
  timestamps, so simulator timelines (cycles, not wall time) render
  through the same exporter (``tasks_to_chrome``).
"""

from __future__ import annotations

import json
import re
import time
from collections import deque

__all__ = [
    "NULL_TRACER",
    "Tracer",
    "tasks_to_chrome",
    "validate_chrome_trace",
]


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span: captures the start on entry, emits one complete ("X")
    event on exit. Nesting falls out of containment — Chrome/Perfetto
    nest same-track complete events by ts/dur."""

    __slots__ = ("_tracer", "name", "cat", "track", "args", "_t0")

    def __init__(self, tracer, name, cat, track, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer.now_us()
        self._tracer.complete(self.name, self._t0, t1 - self._t0,
                              cat=self.cat, track=self.track,
                              args=self.args)
        return False


class Tracer:
    """Bounded span/event recorder with Chrome trace-event export."""

    def __init__(self, enabled: bool = True, *, max_events: int = 1 << 16,
                 clock=time.perf_counter, pid: int = 0):
        if max_events <= 0:
            raise ValueError(f"max_events must be positive: {max_events}")
        self.enabled = enabled
        self.max_events = max_events
        self.pid = pid
        self._clock = clock
        self._t0 = clock()
        self._events: deque = deque(maxlen=max_events)
        self.dropped = 0
        self._tracks: dict[str, int] = {}

    # -- clock ------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer creation (monotonic)."""
        return (self._clock() - self._t0) * 1e6

    def to_us(self, clock_value: float) -> float:
        """Convert a raw reading of this tracer's clock to trace time —
        lets callers timestamp with values they already captured for
        metrics instead of paying extra clock reads."""
        return (clock_value - self._t0) * 1e6

    # -- recording --------------------------------------------------------

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks)
            self._tracks[track] = tid
        return tid

    def _emit(self, ev: dict) -> None:
        if len(self._events) == self.max_events:
            self.dropped += 1
        self._events.append(ev)

    def span(self, name: str, *, track: str = "main", cat: str = "",
             args: dict | None = None):
        """Context manager measuring one wall-clock span."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, track, args)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 track: str = "main", cat: str = "",
                 args: dict | None = None) -> None:
        """One complete ("X") event at explicit timestamps — the hook
        virtual-time exporters (sim timelines) and spans share."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
              "pid": self.pid, "tid": self._tid(track)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._emit(ev)

    def begin(self, name: str, *, track: str = "main", cat: str = "",
              args: dict | None = None) -> None:
        """Open a duration ("B") event; pair with ``end``. Used for
        spans whose start/end sites are far apart (request lifecycles)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "B", "ts": self.now_us(),
              "pid": self.pid, "tid": self._tid(track)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._emit(ev)

    def end(self, name: str, *, track: str = "main",
            args: dict | None = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "E", "ts": self.now_us(),
              "pid": self.pid, "tid": self._tid(track)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, *, track: str = "main", cat: str = "",
                args: dict | None = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "ts": self.now_us(), "s": "t",
              "pid": self.pid, "tid": self._tid(track)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, value: float, *,
                track: str = "counters") -> None:
        """One sample of a counter ("C") series — renders as a filled
        area track in Perfetto (e.g. pool occupancy over time)."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C", "ts": self.now_us(),
                    "pid": self.pid, "tid": self._tid(track),
                    "args": {"value": value}})

    # -- export -----------------------------------------------------------

    def export(self) -> dict:
        """Chrome trace-event JSON object (sorted by ts, with track-name
        metadata). Ring-buffer truncation is flagged both in
        ``otherData`` and as an instant event at the head of the trace."""
        events = sorted(self._events, key=lambda e: e["ts"])
        meta = [
            {"name": "thread_name", "ph": "M", "pid": self.pid, "tid": tid,
             "args": {"name": track}}
            for track, tid in self._tracks.items()
        ]
        if self.dropped:
            first_ts = events[0]["ts"] if events else 0.0
            meta.append({"name": "ring_buffer_truncated", "ph": "i",
                         "ts": first_ts, "s": "g", "pid": self.pid,
                         "tid": 0,
                         "args": {"dropped_events": self.dropped}})
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "dropped_events": self.dropped,
                "complete": self.dropped == 0,
            },
        }

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1)
            f.write("\n")


NULL_TRACER = Tracer(enabled=False, max_events=1)


# ---------------------------------------------------------------------------
# simulator timeline -> Chrome trace
# ---------------------------------------------------------------------------

# sim unit -> display track. The sim calls the matmul stream "MAC"; the
# serving-side docs call the same stream MXU — the trace uses the
# hardware name so measured and simulated timelines read alike.
_UNIT_TRACKS = {"MAC": "MXU", "VEC": "VEC", "DMA": "DMA"}

_TAG_KEY = re.compile(r"[A-Za-z_+]+")


def tag_key(tag: str) -> str:
    """Collapse a per-tile tag ("C3.1", "Vreload0.2") to its family
    ("C", "Vreload") — the grouping ``SimResult.busy_by_tag`` uses."""
    m = _TAG_KEY.match(tag)
    return m.group(0) if m else tag


def tasks_to_chrome(timeline, freq_ghz: float | None = None,
                    name: str = "sim") -> dict:
    """Render a resolved sim timeline (``simulate(..,
    return_timeline=True)``) as Chrome trace JSON on VEC/MXU/DMA tracks.

    ``freq_ghz`` converts cycles to microseconds so simulated and
    measured traces share a time axis; ``None`` keeps raw cycles as the
    ``ts`` unit (self-consistent, just not wall time).
    """
    scale = 1.0 / (freq_ghz * 1e3) if freq_ghz else 1.0
    tr = Tracer(enabled=True, max_events=max(1, 2 * len(timeline)))
    for t in timeline:
        args = {"cycles": t.cycles, "tag": t.tag}
        if t.dram_read_bytes:
            args["dram_read_bytes"] = t.dram_read_bytes
        if t.dram_write_bytes:
            args["dram_write_bytes"] = t.dram_write_bytes
        if t.l1_bytes:
            args["l1_bytes"] = t.l1_bytes
        if t.mac_ops:
            args["mac_ops"] = t.mac_ops
        if t.vec_ops:
            args["vec_ops"] = t.vec_ops
        tr.complete(tag_key(t.tag) or t.unit, t.start * scale,
                    t.cycles * scale,
                    track=_UNIT_TRACKS.get(t.unit, t.unit), cat="sim",
                    args=args)
    out = tr.export()
    out["otherData"]["source"] = name
    out["otherData"]["time_unit"] = "us" if freq_ghz else "cycles"
    return out


# ---------------------------------------------------------------------------
# validation (used by tests and scripts/validate_trace.py)
# ---------------------------------------------------------------------------

_KNOWN_PHASES = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n"}


def validate_chrome_trace(trace: dict) -> list[str]:
    """Structural validation of an exported trace. Returns a list of
    problems (empty == valid): required keys per phase, numeric
    non-negative timestamps, non-decreasing ``ts`` order, and matched
    B/E stacks per (pid, tid)."""
    errors: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts: float | None = None
    stacks: dict[tuple, list[str]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        name = ev.get("name")
        if ph not in _KNOWN_PHASES:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if not isinstance(name, str) or not name:
            errors.append(f"event {i}: missing name")
        if ph == "M":
            continue  # metadata events carry no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"event {i} ({name}): non-numeric ts {ts!r}")
            continue
        if ts < 0:
            errors.append(f"event {i} ({name}): negative ts {ts}")
        if last_ts is not None and ts < last_ts:
            errors.append(
                f"event {i} ({name}): ts {ts} < previous {last_ts} "
                f"(export must be time-sorted)")
        last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({name}): bad dur {dur!r}")
        elif ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                name)
        elif ph == "E":
            stack = stacks.setdefault((ev.get("pid"), ev.get("tid")), [])
            if not stack:
                errors.append(f"event {i} ({name}): E without open B")
            else:
                opened = stack.pop()
                if opened != name:
                    errors.append(
                        f"event {i}: E({name}) closes B({opened}) — "
                        f"mis-nested spans")
    for (pid, tid), stack in stacks.items():
        if stack:
            errors.append(
                f"unclosed B events on pid={pid} tid={tid}: {stack}")
    other = trace.get("otherData", {})
    if other.get("dropped_events") and other.get("complete", False):
        errors.append("dropped_events > 0 but trace marked complete")
    return errors
