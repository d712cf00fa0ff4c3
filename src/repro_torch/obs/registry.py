"""Single metrics registry: counters, gauges, mergeable histograms (a
copy of the reference's `obs/registry.py`; this package has its own
`REGISTRY`).

Unlike the tracer this is *always on* — publishing is a couple of dict
operations, the same cost class as the stats dicts the engines already
maintain. Histograms use fixed bucket boundaries declared at creation,
so per-process histograms with the same boundaries merge by adding
counts and percentiles stay well-defined across a future multi-process
fleet (no t-digest approximation drift, no resampling).

`snapshot()` is plain-JSON-able; none of its keys collide with the
benchmark wall-clock leaf names (``seconds``/``wall_s``/``total_s``)
so embedding a snapshot in a BENCH record never perturbs the baseline
wall diff in ``benchmarks/run.py``.
"""
from __future__ import annotations

import bisect
from typing import Mapping, Sequence

# powers of two from 1 tick/unit up to 64k — serving latencies are in
# scheduler ticks, so integer-friendly boundaries merge cleanly
DEFAULT_BUCKETS: tuple[float, ...] = tuple(float(1 << i) for i in range(17))


class Counter:
    """Monotonic cumulative count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def _zero(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins sample."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def _zero(self) -> None:
        self.value = 0.0

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-boundary histogram: ``len(bounds)+1`` buckets, the last
    catching everything above the top boundary. Two histograms with
    identical boundaries merge exactly by adding counts."""

    __slots__ = ("name", "bounds", "counts", "total", "count")

    def __init__(self, name: str, bounds: Sequence[float] = DEFAULT_BUCKETS):
        if list(bounds) != sorted(bounds) or len(bounds) < 1:
            raise ValueError(f"histogram bounds must be sorted, non-empty: {bounds}")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.name} vs {other.name}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.count += other.count

    def percentile(self, q: float) -> float:
        """Bucket-upper-bound percentile estimate (conservative, and
        identical no matter how the observations were sharded)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c > 0:
                if i < len(self.bounds):
                    return self.bounds[i]
                return self.bounds[-1]  # overflow bucket: clamp to top
        return self.bounds[-1]

    def _zero(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def snapshot(self):
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.total,
            "count": self.count,
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Name → metric. ``counter/gauge/histogram`` create on first use;
    re-registering the same name with a different type is an error."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another process's registry into this one (counters add,
        gauges last-write-win, histograms merge bucket-wise)."""
        for name, m in other._metrics.items():
            if isinstance(m, Counter):
                self.counter(name).inc(m.value)
            elif isinstance(m, Gauge):
                self.gauge(name).set(m.value)
            else:
                self.histogram(name, m.bounds).merge(m)

    def reset(self) -> None:
        """Zero every metric in place — references handed out earlier
        stay live, so per-figure resets don't orphan publishers."""
        for m in self._metrics.values():
            m._zero()

    def snapshot(self) -> dict:
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def reset() -> None:
    REGISTRY.reset()


_KV_GAUGES = (
    "blocks_in_use", "peak_blocks", "evictable_blocks", "live_tokens",
    "live_block_demand", "ref_total", "prefix_hits", "prefix_misses",
    "prefix_hit_tokens", "prefix_entries",
)


def publish_kv_stats(stats: Mapping, prefix: str = "kv") -> None:
    """Mirror a KVStore ``stats`` dict into gauges. The store's own
    hit/use numbers are already cumulative, so gauges (not counters)
    keep re-publication per tick idempotent."""
    for k in _KV_GAUGES:
        v = stats.get(k)
        if v is not None:
            REGISTRY.gauge(f"{prefix}.{k}").set(float(v))


__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTRY", "get_registry", "publish_kv_stats", "reset",
]
