"""TraceGraph: unified observability for the serving/dataflow stack (a
copy of the reference's `obs` package, which holds no JAX).

Three small pieces (DESIGN.md §16):

- ``obs.trace``    — low-overhead hierarchical span tracer (one-branch
  no-op when disabled) with per-track ids and request-lifecycle flows.
- ``obs.registry`` — always-on metrics registry (counters, gauges,
  fixed-bucket histograms whose percentiles merge across processes).
- ``obs.export``   — Chrome trace-event / Perfetto JSON exporter plus
  a plain-JSON metrics dump and a schema validator.
"""

from repro_torch.obs import export, registry, trace

__all__ = ["export", "registry", "trace"]
