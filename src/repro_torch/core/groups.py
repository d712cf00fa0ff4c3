"""Group formation: the paper's ``G_0..G_k`` process groups over the
rows of a rank world (a port of the reference's `core/groups.py`).

The paper (Sec. II-C) forms groups of processes and maps each operation
to exactly one group. The world's rows (`launch.mesh.Mesh`, one process
per row of the ``data`` axis) are partitioned into contiguous row
ranges, one per group. The ``compute`` group is implicit: it holds the
rows no service group claims. ``alpha`` (Eqs. 2-4) is the fraction of
rows given to a decoupled operation, resolved to an integer (>= 1 when
requested > 0). Row arithmetic is the reference's, value for value.

Building a `GroupedMesh` inside a world also creates one process group
per group of two or more rows (`Mesh.new_group`), in declaration order:
that call is collective, so every rank builds the same groups in the
same order, once. A group of one row needs none (its reductions are
the identity).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np

COMPUTE = "compute"


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One group: a named contiguous row range [start, stop)."""

    name: str
    start: int
    stop: int  # exclusive

    @property
    def size(self) -> int:
        return self.stop - self.start

    @property
    def rows(self) -> range:
        return range(self.start, self.stop)


@dataclasses.dataclass(frozen=True)
class GroupedMesh:
    """A mesh whose rows are partitioned into operation groups: rows
    ``[0, compute_rows)`` compute, service groups on the tail rows in
    declaration order (the paper's G_0 / G_1.. layout). ``pgroups`` maps
    a group's name to its process group (None for one row, or outside a
    world)."""

    mesh: object  # launch.mesh.Mesh
    axis: str
    groups: tuple[GroupSpec, ...]
    pgroups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(mesh, axis: str = "data", services: Mapping[str, float] | None = None,
              min_compute_rows: int = 1) -> "GroupedMesh":
        """Resolve fractional alphas to integer row counts: every service
        with alpha > 0 gets max(1, round(alpha * rows)) tail rows."""
        n = mesh.shape[axis]
        sizes: dict[str, int] = {}
        for name, frac in dict(services or {}).items():
            if not 0.0 <= frac < 1.0:
                raise ValueError(f"service {name!r}: alpha={frac} outside [0,1)")
            if frac > 0.0:
                sizes[name] = max(1, int(round(frac * n)))
        return GroupedMesh.build_rows(mesh, axis=axis, rows=sizes,
                                      min_compute_rows=min_compute_rows)

    @staticmethod
    def build_rows(mesh, axis: str = "data", rows: Mapping[str, int] | None = None,
                   min_compute_rows: int = 1) -> "GroupedMesh":
        """Exact per-service row counts (the adaptive loop's regroup path)."""
        sizes = dict(rows or {})
        n = mesh.shape[axis]
        for name, size in sizes.items():
            if name == COMPUTE:
                raise ValueError("the compute group's rows are implicit")
            if int(size) != size or size < 1:
                raise ValueError(f"service {name!r}: rows={size} must be int >= 1")
        used = sum(sizes.values())
        compute_rows = n - used
        if compute_rows < min_compute_rows:
            raise ValueError(
                f"axis {axis!r} has {n} rows; services demand {used}, "
                f"leaving {compute_rows} < min_compute_rows={min_compute_rows}")
        specs = [GroupSpec(COMPUTE, 0, compute_rows)]
        cursor = compute_rows
        for name, size in sizes.items():
            specs.append(GroupSpec(name, cursor, cursor + int(size)))
            cursor += int(size)
        # collective, in declaration order, on every rank alike
        pgroups = {g.name: mesh.new_group(g.rows) for g in specs}
        return GroupedMesh(mesh=mesh, axis=axis, groups=tuple(specs), pgroups=pgroups)

    @staticmethod
    def trivial(mesh, axis: str = "data") -> "GroupedMesh":
        """All rows compute: the conventional (non-decoupled) model."""
        return GroupedMesh.build(mesh, axis=axis, services={})

    # -- queries ----------------------------------------------------------
    def group(self, name: str) -> GroupSpec:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(name)

    def has(self, name: str) -> bool:
        return any(g.name == name for g in self.groups)

    def rows_of(self, name: str) -> range:
        return self.group(name).rows

    @property
    def axis_size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def compute(self) -> GroupSpec:
        return self.group(COMPUTE)

    @property
    def service_groups(self) -> tuple[GroupSpec, ...]:
        return tuple(g for g in self.groups if g.name != COMPUTE)

    def alpha(self, name: str) -> float:
        """Realised alpha (Eq. 2): the fraction of rows in group ``name``."""
        return self.group(name).size / self.axis_size

    def is_member(self, name: str, row: int | None = None) -> bool:
        """Whether ``row`` (this rank's row by default) is in group ``name``."""
        row = self.mesh.row if row is None else row
        g = self.group(name)
        return g.start <= row < g.stop

    def role_mask(self, name: str) -> np.ndarray:
        """Boolean per-row mask of group membership."""
        m = np.zeros(self.axis_size, dtype=bool)
        g = self.group(name)
        m[g.start:g.stop] = True
        return m

    def describe(self) -> str:
        parts = [f"{g.name}[{g.start}:{g.stop}] (alpha={g.size / self.axis_size:.4f})"
                 for g in self.groups]
        return f"GroupedMesh(axis={self.axis!r}, {', '.join(parts)})"


def batch_rows_padding(global_batch: int, compute_rows: int) -> tuple[int, int]:
    """Padded per-row batch and padded global batch for a grouped mesh:
    the global batch is sharded over the compute rows only, padded when
    the division is uneven (the paper keeps the total workload, Sec. IV-A)."""
    per_row = math.ceil(global_batch / compute_rows)
    return per_row, per_row * compute_rows


__all__ = ["COMPUTE", "GroupSpec", "GroupedMesh", "batch_rows_padding"]
