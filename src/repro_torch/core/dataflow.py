"""ServiceGraph: the paper's multi-group dataflow (Sec. II-C, Fig. 3c),
declared once on one `GroupedMesh` (a port of the topology half of the
reference's `core/dataflow.py`).

    graph = ServiceGraph.build(mesh, stages={"reduce": 1 / 8, "io": 1 / 8},
                               edges=[("compute", "reduce"), ("reduce", "io")])

resolves every stage onto one row partition of the world, validates the
declared edges and hands out their channels, each with the wire (codec
and chunk granularity) declared for its edge. The pipelined executor
(`Stage`, `run`/`run_chain`) and `regroup` are not ported yet (ROADMAP
A8/A10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from repro_torch.core.channel import StreamChannel, broadcast_from_row
from repro_torch.core.groups import COMPUTE, GroupedMesh
from repro_torch.core.wire import WireSpec, get_codec


@dataclasses.dataclass(frozen=True)
class ServiceGraph:
    """Named service stages and directed channels on one mesh."""

    gmesh: GroupedMesh
    edges: tuple[tuple[str, str], ...]
    # ((src, dst), WireSpec) per declared wire; other edges use identity
    wires: tuple[tuple[tuple[str, str], WireSpec], ...] = ()

    @staticmethod
    def build(mesh, *, stages: Mapping[str, float], edges: Sequence[tuple[str, str]] = (),
              axis: str = "data", min_compute_rows: int = 1,
              wire: Mapping[tuple[str, str], "WireSpec | str"] | None = None
              ) -> "ServiceGraph":
        """Resolve fractional per-stage alphas onto one `GroupedMesh` and
        validate the declared edges against its groups."""
        gmesh = GroupedMesh.build(mesh, axis=axis, services=dict(stages),
                                  min_compute_rows=min_compute_rows)
        return ServiceGraph.from_grouped(gmesh, edges, wire=wire)

    @staticmethod
    def from_grouped(gmesh: GroupedMesh, edges: Sequence[tuple[str, str]] = (),
                     wire: Mapping[tuple[str, str], "WireSpec | str"] | None = None
                     ) -> "ServiceGraph":
        """Declare channels on an existing `GroupedMesh`."""
        edges = [tuple(e) for e in edges]
        seen = set()
        for src, dst in edges:
            if src == dst:
                raise ValueError(f"self-edge {src!r} -> {dst!r}")
            for name in (src, dst):
                if not gmesh.has(name):
                    raise KeyError(f"edge ({src!r}, {dst!r}) references unknown group "
                                   f"{name!r}; mesh has {[g.name for g in gmesh.groups]}")
            if (src, dst) in seen:
                raise ValueError(f"duplicate edge {src!r} -> {dst!r}")
            seen.add((src, dst))
        wires = []
        for edge, spec in (wire or {}).items():
            if tuple(edge) not in seen:
                raise KeyError(f"wire for undeclared edge {edge!r}")
            wires.append((tuple(edge), WireSpec.of(spec)))
        return ServiceGraph(gmesh=gmesh, edges=tuple(edges), wires=tuple(wires))

    def has_edge(self, src: str, dst: str) -> bool:
        return (src, dst) in self.edges

    def wire_spec(self, src: str, dst: str) -> WireSpec:
        """The wire declared on an edge (identity if none was)."""
        for edge, spec in self.wires:
            if edge == (src, dst):
                return spec
        return WireSpec()

    def channel(self, src: str, dst: str) -> StreamChannel:
        """The channel of a declared edge, with the edge's wire."""
        if not self.has_edge(src, dst):
            raise KeyError(f"edge ({src!r}, {dst!r}) not declared; have {self.edges}")
        spec = self.wire_spec(src, dst)
        return StreamChannel(gmesh=self.gmesh, producer=src, consumer=dst,
                             codec=get_codec(spec.codec), chunk_bytes=spec.chunk_bytes)

    @property
    def alphas(self) -> dict[str, float]:
        """Realised per-stage alphas (Eq. 2 generalised)."""
        return {g.name: self.gmesh.alpha(g.name) for g in self.gmesh.service_groups}

    def describe(self) -> str:
        arrows = ", ".join(f"{s}->{d}" for s, d in self.edges)
        return f"ServiceGraph({self.gmesh.describe()}, edges=[{arrows}])"

    def broadcast_from(self, group: str, value: Any) -> Any:
        """``group``'s (replicated) result on every row, bit for bit."""
        return broadcast_from_row(self.gmesh, self.gmesh.group(group).start, value)


def work_vector(gmesh: GroupedMesh, work) -> torch.Tensor:
    """Every row's scalar work figure gathered into one ``(rows,)`` f32
    vector, the same on every row (one sum over the world)."""
    onehot = torch.zeros(gmesh.axis_size, dtype=torch.float32)
    onehot[gmesh.mesh.row] = float(work)
    return gmesh.mesh.all_reduce(onehot)


__all__ = ["COMPUTE", "ServiceGraph", "work_vector"]
