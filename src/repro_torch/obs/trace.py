"""Low-overhead event tracer with hierarchical spans (a copy of the
reference's `obs/trace.py`: the same events, tracks and flows, so both
packages' traces compare event for event).

Model (DESIGN.md §16): events land on *tracks*, a ``(process, thread)``
string pair — process is a stage group ("prefill", "decode", "fleet",
"graph", …), thread a row/slot/request within it. Five event kinds map
1:1 onto Chrome trace-event phases: begin/end pairs (B/E) for spans,
complete (X) when the duration is known after the fact, instant (i)
markers, and counter (C) series. Request lifecycles are spans on a
dedicated ``("requests", "req<uid>")`` track tied together with flow
events (s/t/f, id = request uid) so one request's hops across
prefill → migrate → decode tracks render as arrows in Perfetto.

Everything is host-side observation on monotonic clocks
(``time.perf_counter_ns``): enabling the tracer never adds, reorders,
or synchronizes device work, so step outputs are bitwise identical
with tracing on or off. When disabled (the default) every module-level
emit is a single ``is None`` branch, and ``span()`` returns one cached
null context manager — hot paths pay one branch and no allocation.

The buffer is a bounded ring (``collections.deque(maxlen=…)``): old
events fall off, ``dropped`` counts them, and lifecycle accounting
(`lifecycle_report`) is kept in side counters so invariant checks
survive ring wrap.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Iterator

Track = tuple[str, str]

MAIN: Track = ("main", "main")
REQUESTS_PROCESS = "requests"

DEFAULT_CAPACITY = 1 << 20


def clock_ns() -> int:
    """Monotonic host clock (ns) — the tracer's one time source."""
    return time.perf_counter_ns()


class _NullSpan:
    """Context manager returned by ``span()`` when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_track")

    def __init__(self, tracer: "Tracer", track: Track):
        self._tracer = tracer
        self._track = track

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc: object) -> bool:
        self._tracer.end(track=self._track)
        return False


def request_track(uid: int) -> Track:
    return (REQUESTS_PROCESS, f"req{uid}")


class Tracer:
    """Ring-buffered event recorder. Use the module-level functions —
    they route to the installed tracer and no-op when none is."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.events: collections.deque[dict] = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self.t0_ns = clock_ns()
        # side accounting that survives ring wrap
        self._open_requests: set[int] = set()
        self.request_begins = 0
        self.request_ends = 0
        self.double_begins = 0
        self.double_ends = 0
        self._depth: collections.Counter[Track] = collections.Counter()

    # -- raw emit ----------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    # -- span events -------------------------------------------------------

    def begin(self, name: str, track: Track = MAIN, **attrs: Any) -> None:
        self._depth[track] += 1
        ev = {"ph": "B", "name": name, "ts": clock_ns(), "track": track}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def end(self, track: Track = MAIN, **attrs: Any) -> None:
        if self._depth[track] > 0:
            self._depth[track] -= 1
        ev = {"ph": "E", "ts": clock_ns(), "track": track}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def span(self, name: str, track: Track = MAIN, **attrs: Any) -> _Span:
        self.begin(name, track, **attrs)
        return _Span(self, track)

    def complete(self, name: str, dur_s: float, track: Track = MAIN,
                 end_ns: int | None = None, **attrs: Any) -> None:
        """An X event whose wall is already measured (e.g. a ledger
        sample); placed so it *ends* now (or at ``end_ns``)."""
        dur_ns = max(0, int(dur_s * 1e9))
        t1 = clock_ns() if end_ns is None else end_ns
        ev = {"ph": "X", "name": name, "ts": t1 - dur_ns, "dur": dur_ns,
              "track": track}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def instant(self, name: str, track: Track = MAIN, **attrs: Any) -> None:
        ev = {"ph": "i", "name": name, "ts": clock_ns(), "track": track}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def counter(self, name: str, values: dict[str, float], track: Track = MAIN) -> None:
        self._emit({"ph": "C", "name": name, "ts": clock_ns(), "track": track,
                    "args": dict(values)})

    # -- request lifecycle + flows ----------------------------------------

    def request_begin(self, uid: int, **attrs: Any) -> None:
        """Open the lifecycle span for request ``uid``. Exactly one per
        accepted submit; re-queues after faults/resizes must NOT call
        this again (guarded, counted in ``double_begins``)."""
        if uid in self._open_requests:
            self.double_begins += 1
            return
        self._open_requests.add(uid)
        self.request_begins += 1
        tr = request_track(uid)
        ts = clock_ns()
        ev = {"ph": "B", "name": "request", "ts": ts, "track": tr}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)
        self._emit({"ph": "s", "name": "req", "ts": ts, "track": tr, "id": uid})

    def request_mark(self, uid: int, name: str, track: Track | None = None,
                     **attrs: Any) -> None:
        """A zero-width hop for ``uid`` on a stage track; flow-linked so
        Perfetto draws the arrow from the lifecycle span through every
        prefill/migrate/decode/retire hop."""
        tr = request_track(uid) if track is None else track
        ts = clock_ns()
        ev = {"ph": "X", "name": name, "ts": ts, "dur": 0, "track": tr,
              "args": {"uid": uid, **attrs}}
        self._emit(ev)
        if uid in self._open_requests:
            self._emit({"ph": "t", "name": "req", "ts": ts, "track": tr, "id": uid})

    def request_end(self, uid: int, **attrs: Any) -> None:
        if uid not in self._open_requests:
            self.double_ends += 1
            return
        self._open_requests.discard(uid)
        self.request_ends += 1
        tr = request_track(uid)
        ts = clock_ns()
        self._emit({"ph": "f", "name": "req", "ts": ts, "track": tr, "id": uid})
        ev = {"ph": "E", "ts": ts, "track": tr}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    # -- introspection -----------------------------------------------------

    def lifecycle_report(self) -> dict:
        """Span-lifecycle invariants; computed from side counters so it
        is exact even after the ring buffer wraps."""
        return {
            "open": sorted(self._open_requests),
            "begins": self.request_begins,
            "ends": self.request_ends,
            "double_begins": self.double_begins,
            "double_ends": self.double_ends,
            "events": len(self.events),
            "dropped": self.dropped,
        }

    def open_depth(self, track: Track) -> int:
        return self._depth[track]

    def __iter__(self) -> Iterator[dict]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)


# ---------------------------------------------------------------------------
# module-level switchboard — the one branch hot paths pay
# ---------------------------------------------------------------------------

_TRACER: Tracer | None = None


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install a fresh tracer and return it."""
    global _TRACER
    _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> Tracer | None:
    """Uninstall and return the tracer (export it afterwards if wanted)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def enabled() -> bool:
    return _TRACER is not None


def get() -> Tracer | None:
    return _TRACER


def span(name: str, track: Track = MAIN, **attrs: Any):
    if _TRACER is None:
        return _NULL_SPAN
    return _TRACER.span(name, track, **attrs)


def begin(name: str, track: Track = MAIN, **attrs: Any) -> None:
    if _TRACER is not None:
        _TRACER.begin(name, track, **attrs)


def end(track: Track = MAIN, **attrs: Any) -> None:
    if _TRACER is not None:
        _TRACER.end(track, **attrs)


def complete(name: str, dur_s: float, track: Track = MAIN,
             end_ns: int | None = None, **attrs: Any) -> None:
    if _TRACER is not None:
        _TRACER.complete(name, dur_s, track, end_ns, **attrs)


def instant(name: str, track: Track = MAIN, **attrs: Any) -> None:
    if _TRACER is not None:
        _TRACER.instant(name, track, **attrs)


def counter(name: str, values: dict[str, float], track: Track = MAIN) -> None:
    if _TRACER is not None:
        _TRACER.counter(name, values, track)


def request_begin(uid: int, **attrs: Any) -> None:
    if _TRACER is not None:
        _TRACER.request_begin(uid, **attrs)


def request_mark(uid: int, name: str, track: Track | None = None, **attrs: Any) -> None:
    if _TRACER is not None:
        _TRACER.request_mark(uid, name, track, **attrs)


def request_end(uid: int, **attrs: Any) -> None:
    if _TRACER is not None:
        _TRACER.request_end(uid, **attrs)


__all__ = [
    "DEFAULT_CAPACITY", "MAIN", "Tracer", "Track", "begin", "clock_ns",
    "complete", "counter", "disable", "enable", "enabled", "end", "get",
    "instant", "request_begin", "request_end", "request_mark",
    "request_track", "span",
]
