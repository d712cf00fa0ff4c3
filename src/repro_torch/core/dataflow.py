"""ServiceGraph: the paper's multi-group dataflow (Sec. II-C, Fig. 3c) as a
runtime over a rank world (a port of the reference's `core/dataflow.py`).

Several operations (reduce, particle communication, I/O) each get their
own group of rows, and stream channels chain the groups, so that
downstream groups consume element ``k`` while upstream groups produce
element ``k+1``. A `ServiceGraph` declares the whole topology once,

    graph = ServiceGraph.build(mesh, stages={"reduce": 1 / 8, "io": 1 / 8},
                               edges=[("compute", "reduce"), ("reduce", "io")])

resolves every stage onto one row partition of the world, validates the
declared edges, hands out their channels (each with its edge's wire) and
runs chains of `Stage`s under a skewed schedule.

Pipelined schedule
------------------
`run()` executes one or more chains. The head stage of a chain drains its
channel one wave at a time (`StreamChannel.stream_fold`'s ``waves=``);
after wave ``k`` folds on the stage's consumer rows, the stage's ``emit``
hook produces the element forwarded on the next edge. At tick ``t`` the
head handles wave ``t`` and stage ``i`` emission ``t - i``, and several
chains advance tick by tick. Every rank walks this schedule in the same
order (tick, chain, stage) and takes part in the transfers of its rows
only, so two chains in one `run` cannot deadlock: each transfer's two
ranks reach it after every earlier transfer either of them takes part in.

Every rank calls ``emit`` on its own state, as every row does in the
reference: on rows outside the stage the state is the stage's ``init``,
which gives the receiving rows the element's shape before anything
arrives; the channel reads the element on the stage's consumer rows
only. Operators fold in place (`core.operators`): `run` folds into a
clone of each stage's ``init``, so a `Stage` can run again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core.channel import Operator, StreamChannel, broadcast_from_row
from repro_torch.core.groups import COMPUTE, GroupedMesh
from repro_torch.core.wire import WireSpec, get_codec
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs import trace as _obs
from repro_torch.utils.treeutil import tree_leaves, tree_map


def _clone(tree: Any) -> Any:
    return tree_map(torch.clone, tree)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One hop of a chain: a declared edge plus the operator folded on the
    destination group as elements arrive.

    ``elements`` (with an optional per-producer ``count``) feeds the HEAD
    stage: a ``(n_chunks, S)`` producer-local buffer, of the same shape on
    every row. Downstream stages receive the previous stage's
    ``emit(acc, k)``, called on every rank after wave ``k`` folds and
    returning the ``(S_next,)`` element forwarded on the next edge; only
    its value on the stage's consumer rows is read."""

    src: str
    dst: str
    operator: Operator
    init: Any
    elements: torch.Tensor | None = None  # head stage only
    count: Any = None  # head stage only
    emit: Callable[[Any, int], torch.Tensor] | None = None  # non-tail stages


@dataclasses.dataclass(frozen=True)
class ServiceGraph:
    """Named service stages and directed channels on one mesh.

    ``gmesh`` hosts every stage as a row range (compute keeps the head
    rows); ``edges`` are the declared channels; ``wires`` the per-edge wire
    declarations (other edges use the identity wire); ``bidir`` the pairs
    declared with ``bidirectional=``, whose two directions each keep their
    own channel and wire, paired by `reverse_channel`."""

    gmesh: GroupedMesh
    edges: tuple[tuple[str, str], ...]
    wires: tuple[tuple[tuple[str, str], WireSpec], ...] = ()
    bidir: tuple[tuple[str, str], ...] = ()

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(mesh, *, stages: Mapping[str, float], edges: Sequence[tuple[str, str]] = (),
              axis: str = "data", min_compute_rows: int = 1,
              wire: Mapping[tuple[str, str], "WireSpec | str"] | None = None,
              bidirectional: Sequence[tuple[str, str]] = ()) -> "ServiceGraph":
        """Resolve fractional per-stage alphas onto one `GroupedMesh` and
        validate the declared edges against its groups. Building the
        groups is collective: every rank builds the same graphs in the
        same order."""
        gmesh = GroupedMesh.build(mesh, axis=axis, services=dict(stages),
                                  min_compute_rows=min_compute_rows)
        return ServiceGraph.from_grouped(gmesh, edges, wire=wire, bidirectional=bidirectional)

    @staticmethod
    def from_grouped(gmesh: GroupedMesh, edges: Sequence[tuple[str, str]] = (),
                     wire: Mapping[tuple[str, str], "WireSpec | str"] | None = None,
                     bidirectional: Sequence[tuple[str, str]] = ()) -> "ServiceGraph":
        """Declare channels on an existing `GroupedMesh`; each
        ``bidirectional`` pair (a, b) declares both directed edges."""
        edges = [tuple(e) for e in edges]
        for a, b in bidirectional:
            for e in ((a, b), (b, a)):
                if e in edges:
                    raise ValueError(f"edge {e!r} declared both directed and bidirectional")
                edges.append(e)
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
        return ServiceGraph(gmesh=gmesh, edges=tuple(edges), wires=tuple(wires),
                            bidir=tuple((a, b) for a, b in bidirectional))

    def regroup(self, rows: Mapping[str, int], *, min_compute_rows: int = 1) -> "ServiceGraph":
        """The same mesh, edges and wires over a new per-stage row vector.
        ``rows`` names exactly the current service groups. New process
        groups are built, collectively: every rank regroups alike, in the
        same order. Row-partitioned state is the caller's to move."""
        names = {g.name for g in self.gmesh.service_groups}
        if set(rows) != names:
            raise KeyError(f"regroup rows {sorted(rows)} must match the current service "
                           f"groups {sorted(names)}")
        gmesh = GroupedMesh.build_rows(
            self.gmesh.mesh, axis=self.gmesh.axis,
            rows={g.name: int(rows[g.name]) for g in self.gmesh.service_groups},
            min_compute_rows=min_compute_rows)
        if _obs.enabled():
            _obs.instant("regroup", ("graph", "control"),
                         **{k: int(v) for k, v in rows.items()})
        return dataclasses.replace(self, gmesh=gmesh)

    # -- queries ----------------------------------------------------------
    def has_edge(self, src: str, dst: str) -> bool:
        return (src, dst) in self.edges

    def is_bidirectional(self, src: str, dst: str) -> bool:
        return (src, dst) in self.bidir or (dst, src) in self.bidir

    def reverse_channel(self, src: str, dst: str) -> StreamChannel:
        """The return path ``dst -> src`` of a pair declared with
        ``bidirectional=``; a plain directed edge has none."""
        if not self.is_bidirectional(src, dst):
            raise KeyError(f"edge ({src!r}, {dst!r}) is not bidirectional; "
                           f"declared pairs: {list(self.bidir)}")
        return self.channel(dst, src)

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

    # -- the pipelined executor (every rank runs it) -------------------------
    def run_chain(self, stages: Sequence[Stage]) -> list[Any]:
        """Pipeline one chain of stages; returns the per-stage states."""
        return self.run([stages])[0]

    def run(self, chains: Sequence[Sequence[Stage]]) -> list[list[Any]]:
        """Run chains of stages under the skewed schedule. Returns, per
        chain, each stage's folded state (meaningful on the stage's
        consumer rows; a clone of ``init`` elsewhere). Tick ``t`` runs,
        for every chain in order, the head stage's wave ``t`` and then
        stage ``i``'s fold of emission ``t - i``."""
        plans = [self._plan_chain(list(chain)) for chain in chains]
        n_ticks = max((p["n_waves"] + len(p["stages"]) - 1) for p in plans) if plans else 0
        for t in range(n_ticks):
            for plan in plans:
                self._tick_chain(plan, t)
        return [p["accs"] for p in plans]

    def _plan_chain(self, stages: list[Stage]) -> dict:
        if not stages:
            raise ValueError("empty chain")
        for i, st in enumerate(stages):
            if not self.has_edge(st.src, st.dst):
                raise KeyError(f"stage {i}: edge ({st.src!r}, {st.dst!r}) not declared")
            if i == 0:
                if st.elements is None:
                    raise ValueError("head stage needs producer-local `elements`")
            else:
                if st.elements is not None:
                    raise ValueError(f"stage {i}: only the head stage takes `elements`")
                if stages[i - 1].dst != st.src:
                    raise ValueError(f"broken chain: stage {i - 1} ends at "
                                     f"{stages[i - 1].dst!r} but stage {i} starts at "
                                     f"{st.src!r}")
            if i < len(stages) - 1 and st.emit is None:
                raise ValueError(f"stage {i}: non-tail stages need an `emit` hook")
        channels = [self.channel(st.src, st.dst) for st in stages]
        return {"stages": stages, "channels": channels,
                "accs": [_clone(st.init) for st in stages],
                "n_waves": channels[0].n_waves,
                # emissions[i][k]: the element forwarded to stage i for head wave k
                "emissions": {i: {} for i in range(1, len(stages))}}

    @staticmethod
    def _tick_chain(plan: dict, t: int) -> None:
        stages: list[Stage] = plan["stages"]
        accs = plan["accs"]
        for i, (stage, ch) in enumerate(zip(stages, plan["channels"])):
            k = t - i  # the head wave this stage handles at tick t
            if not 0 <= k < plan["n_waves"]:
                continue
            # a host-side span: it shows the schedule (which stage took
            # which wave at which tick) as the host issued it; it never
            # waits for the device
            with _obs.span(f"{stage.src}->{stage.dst}", ("graph", f"stage{i}"), wave=k, tick=t):
                if i == 0:
                    accs[0] = ch.stream_fold(stage.elements, stage.operator, accs[0],
                                             count=stage.count, waves=[k])
                else:
                    # one emission, every wave of this edge, the operator's
                    # stream step re-indexed to k
                    elem = plan["emissions"][i].pop(k)
                    op = stage.operator
                    accs[i] = ch.stream_fold(elem[None, :],
                                             lambda acc, e, _j, _op=op, _k=k: _op(acc, e, _k),
                                             accs[i])
                if i < len(stages) - 1:
                    plan["emissions"][i + 1][k] = stage.emit(accs[i], k)


def delta_emitter(init: Any) -> Callable[[Any, int], Any]:
    """An ``emit`` hook forwarding per-wave *deltas* of an additive state:
    the emissions of every wave sum to the stage's final state, exactly for
    integer-valued float payloads (counts, histograms). It keeps a copy of
    the previous state (operators fold in place): build a fresh one per
    `run`/`run_chain`."""
    prev = {"acc": _clone(init)}

    def emit(acc, k):
        delta = tree_map(torch.sub, acc, prev["acc"])
        prev["acc"] = _clone(acc)
        return delta

    return emit


def sink_sum_stage(src: str, dst: str, width: int, dtype=torch.float32, *,
                   device=None) -> Stage:
    """A sink stage summing forwarded ``(width,)`` elements (its state on
    ``device``: cuda unless named)."""
    return Stage(src=src, dst=dst, operator=lambda acc, elem, k: acc.add_(elem.to(dtype)),
                 init=torch.zeros((width,), dtype=dtype, device=resolve_device(device)))


# -- measurement hooks (the adaptive loop's counters) ---------------------------


def work_vector(gmesh: GroupedMesh, work) -> torch.Tensor:
    """Every row's scalar work figure gathered into one ``(rows,)`` f32
    vector, the same on every row (one sum over the world)."""
    onehot = torch.zeros(gmesh.axis_size, dtype=torch.float32)
    onehot[gmesh.mesh.row] = float(work)
    return gmesh.mesh.all_reduce(onehot)


def with_work_probe(stage: Stage, work_of: Callable[[torch.Tensor], Any] | None = None
                    ) -> Stage:
    """The stage, whose operator also folds a work counter through the
    stage's own channel: its state becomes ``(acc, count)``, and each
    arriving element adds ``work_of(elem)`` (default 1) on the consumer
    rows, so the counter sees exactly the elements the payload saw; an
    ``emit`` hook still sees the bare acc."""
    op = stage.operator
    measure = work_of or (lambda elem: 1.0)
    device = tree_leaves(stage.init)[0].device

    def probed(state, elem, k):
        acc, count = state
        return op(acc, elem, k), count + torch.as_tensor(measure(elem), device=device).float()

    emit = stage.emit
    if emit is not None:
        inner = emit
        emit = lambda state, k: inner(state[0], k)  # noqa: E731
    return dataclasses.replace(
        stage, operator=probed,
        init=(stage.init, torch.zeros((), dtype=torch.float32, device=device)), emit=emit)


__all__ = ["COMPUTE", "ServiceGraph", "Stage", "delta_emitter", "sink_sum_stage",
           "with_work_probe", "work_vector"]
