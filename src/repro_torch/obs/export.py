"""Chrome trace-event / Perfetto JSON export + schema validation (a copy
of the reference's `obs/export.py`).

`chrome_trace` maps tracer tracks onto the trace-event process/thread
model: each distinct track *process* ("prefill", "decode", "fleet",
"graph", "requests", …) becomes a pid with a ``process_name`` metadata
record, each track *thread* (row/slot/request id) a tid with a
``thread_name`` record. Timestamps are microseconds relative to the
tracer's enable time. Flow events (s/t/f, id = request uid) tie one
request's hops across processes into a single arrowed path.

Open the output at https://ui.perfetto.dev or ``chrome://tracing``.

`validate_chrome_trace` is the schema gate CI runs on exported traces:
structurally well-formed events, known phases, required fields per
phase, and every flow id resolving (≥1 start and ≥1 finish).
"""
from __future__ import annotations

import json
from typing import Any

from repro_torch.obs import registry as _registry
from repro_torch.obs import trace as _trace

_REQUIRED = {"B": ("name",), "E": (), "X": ("name", "dur"), "i": ("name",),
             "C": ("name", "args"), "s": ("id",), "t": ("id",), "f": ("id",),
             "M": ("name",)}


def chrome_trace(tracer: _trace.Tracer | None = None, *,
                 metrics: dict | None = None) -> dict:
    """Render a tracer's ring buffer as a Chrome trace-event object."""
    tracer = tracer if tracer is not None else _trace.get()
    if tracer is None:
        raise ValueError("no tracer given and none installed (obs.trace.enable())")
    pids: dict[str, int] = {}
    tids: dict[tuple[str, str], int] = {}
    events: list[dict] = []

    def ids(track: tuple[str, str]) -> tuple[int, int]:
        proc, thread = track
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": proc}})
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = sum(1 for t in tids if t[0] == proc) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": thread}})
        return pid, tid

    t0 = tracer.t0_ns
    for ev in tracer.events:
        pid, tid = ids(ev["track"])
        out: dict[str, Any] = {"ph": ev["ph"], "pid": pid, "tid": tid,
                               "ts": (ev["ts"] - t0) / 1e3}
        ph = ev["ph"]
        if "name" in ev:
            out["name"] = ev["name"]
        if "args" in ev:
            out["args"] = ev["args"]
        if ph == "X":
            out["dur"] = ev["dur"] / 1e3
        elif ph == "i":
            out["s"] = "t"  # thread-scoped instant
        elif ph in ("s", "t", "f"):
            out["cat"] = "flow"
            out["id"] = ev["id"]
            if ph == "f":
                out["bp"] = "e"  # bind to the enclosing slice's end
        events.append(out)

    obj: dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro_torch.obs (TraceGraph)",
            "dropped_events": tracer.dropped,
            "lifecycle": tracer.lifecycle_report(),
        },
    }
    if metrics is not None:
        obj["otherData"]["metrics"] = metrics
    return obj


def write_trace(path: str, tracer: _trace.Tracer | None = None, *,
                metrics: dict | None = None) -> dict:
    """Export to ``path`` (JSON object format) and return the object."""
    obj = chrome_trace(tracer, metrics=metrics)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def metrics_dump(reg: _registry.MetricsRegistry | None = None) -> dict:
    """Plain-JSON snapshot of the (global, by default) metrics registry."""
    return (reg or _registry.get_registry()).snapshot()


def validate_chrome_trace(obj: dict) -> list[str]:
    """Return a list of schema violations (empty = valid)."""
    errors: list[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    flow_starts: set = set()
    flow_steps: set = set()
    flow_finishes: set = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _REQUIRED:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph != "M":
            for key in ("pid", "tid"):
                if not isinstance(ev.get(key), int):
                    errors.append(f"event {i} ({ph}): missing int {key}")
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"event {i} ({ph}): missing numeric ts")
        for key in _REQUIRED[ph]:
            if key not in ev:
                errors.append(f"event {i} ({ph}): missing {key!r}")
        if ph == "s":
            flow_starts.add(ev.get("id"))
        elif ph == "t":
            flow_steps.add(ev.get("id"))
        elif ph == "f":
            flow_finishes.add(ev.get("id"))
    for fid in sorted(flow_steps - flow_starts, key=repr):
        errors.append(f"flow id {fid!r}: step without start")
    for fid in sorted(flow_finishes - flow_starts, key=repr):
        errors.append(f"flow id {fid!r}: finish without start")
    for fid in sorted(flow_starts - flow_finishes, key=repr):
        errors.append(f"flow id {fid!r}: start without finish")
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        errors.append(f"not JSON-serializable: {e}")
    return errors


def assert_valid_chrome_trace(obj: dict) -> None:
    errors = validate_chrome_trace(obj)
    if errors:
        head = "; ".join(errors[:10])
        raise ValueError(f"invalid chrome trace ({len(errors)} errors): {head}")


__all__ = [
    "assert_valid_chrome_trace", "chrome_trace", "metrics_dump",
    "validate_chrome_trace", "write_trace",
]
