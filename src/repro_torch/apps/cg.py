"""Conjugate-gradient Poisson solver: the paper's Sec. IV-C case study (a
port of the reference's `apps/cg.py`).

The 3-D Poisson equation on a Cartesian grid, 7-point Laplacian, a 1-D
domain decomposition over the ``data`` axis (each compute row owns an
x-slab; Dirichlet zero planes beyond the first and last slab, periodic in
y and z). Three halo-exchange variants, the paper's Fig. 6 bars:

  blocking      both halo planes cross the wire (`Mesh.isend`/`irecv`
                with the two neighbours) and arrive before the stencil
                starts: the data dependency stalls on the wire.
  nonblocking   the exchange is posted first, the INNER Laplacian runs on
                the device while gloo moves the planes, then the boundary
                planes are patched in (Hoefler et al.'s overlap).
                `Mesh.isend` copies a plane to the host before it returns,
                so what overlaps is gloo's transfer with the stencil.
  decoupled     every compute row streams its two boundary planes to the
                halo service row, which assembles each row's (below,
                above) pair and sends it back in one message: each compute
                row talks to ONE service peer instead of two neighbours,
                while its inner stencil runs.

Blocking and nonblocking do the same arithmetic in the same order (inner
Laplacian, halo add, negation) and agree bit for bit. All three run a
fixed iteration count (the paper: 300).

Everything but the host entry point `cg_world` is this rank's part of the
computation (`launch.mesh`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.dataflow import ServiceGraph
from repro_torch.core.decouple import group_psum
from repro_torch.core.groups import COMPUTE, GroupedMesh

MODES = ("blocking", "nonblocking", "decoupled")
HALO = "halo"


@dataclasses.dataclass(frozen=True)
class CGCfg:
    nx_local: int = 16  # slab thickness per row (paper: 120^3 per process)
    ny: int = 16
    nz: int = 16
    n_iters: int = 30  # paper: 300
    mode: str = "blocking"  # blocking | nonblocking | decoupled


# -- halo exchange variants ----------------------------------------------------

def _neighbor_perms(rows: range) -> tuple[list, list]:
    """(send-up pairs, send-down pairs) between consecutive rows."""
    lo = list(rows)
    up = [(lo[i], lo[i + 1]) for i in range(len(lo) - 1)]
    dn = [(lo[i + 1], lo[i]) for i in range(len(lo) - 1)]
    return up, dn


def _post_exchange(u: torch.Tensor, gmesh: GroupedMesh):
    """Post this row's halo transfers with its compute neighbours: its top
    plane up and its bottom plane down, and the receives of the planes
    below (row - 1's top) and above (row + 1's bottom). Returns a function
    that waits for them and gives (below, above); a missing neighbour
    (the first and last compute rows, and rows outside the compute group)
    gives a zero plane, the Dirichlet boundary."""
    mesh = gmesh.mesh
    up, dn = _neighbor_perms(gmesh.rows_of(COMPUTE))
    plane = u.shape[1:]
    recv_below = next((mesh.irecv(plane, u.dtype, s) for s, d in up if d == mesh.row), None)
    recv_above = next((mesh.irecv(plane, u.dtype, s) for s, d in dn if d == mesh.row), None)
    sends = [mesh.isend(u[-1], d) for s, d in up if s == mesh.row]
    sends += [mesh.isend(u[0], d) for s, d in dn if s == mesh.row]

    def finish() -> tuple[torch.Tensor, torch.Tensor]:
        below = recv_below.wait() if recv_below is not None else torch.zeros_like(u[0])
        above = recv_above.wait() if recv_above is not None else torch.zeros_like(u[0])
        for s in sends:
            s.wait()
        return below, above

    return finish


def _laplacian_inner(u: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian from the local planes only (periodic in y and z;
    the x-halo planes are patched in by `_apply_halo`)."""
    lap = -6.0 * u
    lap[1:] += u[:-1]  # lower x-neighbour (local part)
    lap[:-1] += u[1:]  # upper x-neighbour (local part)
    lap = lap + torch.roll(u, 1, dims=1) + torch.roll(u, -1, dims=1)
    lap = lap + torch.roll(u, 1, dims=2) + torch.roll(u, -1, dims=2)
    return lap


def _apply_halo(lap: torch.Tensor, below: torch.Tensor, above: torch.Tensor) -> torch.Tensor:
    """Add the neighbours' planes into the first and last plane (in place)."""
    lap[0] += below
    lap[-1] += above
    return lap


def _halo_service(planes: torch.Tensor, gmesh: GroupedMesh):
    """The halo service group's bundling (decoupled mode). Every compute row
    sends its ``(2, ny, nz)`` planes (bottom, top) to the first halo row,
    which assembles row i's pair (top of row i-1, bottom of row i+1;
    zeros at the ends) and sends each row its pair back in one message.

    On a compute row this posts its send and the bundle's receive and
    returns a function that waits and gives ``(2, ny, nz)``; on the halo
    row it serves every compute row, then returns a function giving
    zeros (as the reference's masked select does there). Every rank walks
    the compute rows in one order, so no two ranks wait on each other."""
    mesh = gmesh.mesh
    comp = list(gmesh.rows_of(COMPUTE))
    halo_row = gmesh.group(HALO).start
    if mesh.row in comp:
        send = mesh.isend(planes, halo_row)
        recv = mesh.irecv(planes.shape, planes.dtype, halo_row)

        def finish() -> torch.Tensor:
            bundle = recv.wait()
            send.wait()
            return bundle

        return finish
    if mesh.row == halo_row:
        pending = [mesh.irecv(planes.shape, planes.dtype, src) for src in comp]
        slots = [p.wait() for p in pending]
        zero = torch.zeros_like(planes[0])
        n = len(comp)
        sends = [mesh.isend(torch.stack([slots[i - 1][1] if i > 0 else zero,
                                         slots[i + 1][0] if i < n - 1 else zero]), dst)
                 for i, dst in enumerate(comp)]
        for s in sends:
            s.wait()
    return lambda: torch.zeros_like(planes)


def _matvec(u: torch.Tensor, gmesh: GroupedMesh, mode: str) -> torch.Tensor:
    """A @ u for the negative Laplacian, with the mode's halo exchange."""
    if mode == "blocking":
        below, above = _post_exchange(u, gmesh)()  # both planes arrive first
        lap = _laplacian_inner(u)
        lap = _apply_halo(lap, below, above)
    elif mode == "nonblocking":
        finish = _post_exchange(u, gmesh)
        lap = _laplacian_inner(u)  # on the device while gloo moves the planes
        below, above = finish()
        lap = _apply_halo(lap, below, above)
    elif mode == "decoupled":
        finish = _halo_service(torch.stack([u[0], u[-1]]), gmesh)
        lap = _laplacian_inner(u)
        bundled = finish()
        lap = _apply_halo(lap, bundled[0], bundled[1])
    else:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return -lap


def _dot(a: torch.Tensor, b: torch.Tensor, gmesh: GroupedMesh, group: str = COMPUTE
         ) -> torch.Tensor:
    """The dot product over ``group``'s rows (rows outside keep their own)."""
    return group_psum(torch.sum(a * b), gmesh, group)


def cg_solve(b_rhs: torch.Tensor, cfg: CGCfg, gmesh: GroupedMesh
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This row's CG iterations from x = 0; returns (u, the residual norm
    sqrt(r.r), the history of r.r per iteration as an ``(n_iters,)``
    tensor), as the reference's scan does."""
    x = torch.zeros_like(b_rhs)
    r = b_rhs
    p = r
    rs = _dot(r, r, gmesh)
    hist = []
    for _ in range(cfg.n_iters):
        ap = _matvec(p, gmesh, cfg.mode)
        alpha = rs / torch.clamp(_dot(p, ap, gmesh), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _dot(r, r, gmesh)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
        hist.append(rs_new)
    return x, torch.sqrt(rs), torch.stack(hist) if hist else rs.new_zeros((0,))


def cg_graph(mesh, mode: str, alpha: float) -> GroupedMesh:
    """The grouped mesh of one mode: a halo service group (``alpha`` of the
    rows) for the decoupled mode, every row computing otherwise."""
    if mode == "decoupled":
        return ServiceGraph.build(mesh, stages={HALO: alpha}, edges=[(COMPUTE, HALO)]).gmesh
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return GroupedMesh.trivial(mesh)


def cg_rhs(cfg: CGCfg, n_rows: int, work_rows: int) -> np.ndarray:
    """The right-hand side as ``(n_rows, nx_per, ny, nz)`` f32: the same
    global ``(nx_local * n_rows, ny, nz)`` normal draws (`default_rng(7)`)
    for every mode, spread over the ``work_rows`` compute rows, the
    service rows' slabs zero (the paper keeps the total workload)."""
    total_nx = cfg.nx_local * n_rows
    if total_nx % work_rows:
        raise ValueError(f"global nx={total_nx} must divide over {work_rows} compute rows "
                         "(pick nx_local divisible by both decompositions)")
    nx_per = total_nx // work_rows
    rng = np.random.default_rng(7)
    rhs_global = rng.standard_normal((total_nx, cfg.ny, cfg.nz)).astype(np.float32)
    pad = np.zeros(((n_rows - work_rows) * nx_per, cfg.ny, cfg.nz), np.float32)
    return np.concatenate([rhs_global, pad]).reshape(n_rows, nx_per, cfg.ny, cfg.nz)


def laplacian_f64(u: np.ndarray) -> np.ndarray:
    """The 7-point Laplacian of the global ``(nx, ny, nz)`` grid in float64
    on the host: Dirichlet in x, periodic in y and z (A u is its negation)."""
    u = u.astype(np.float64)
    lap = -6.0 * u
    lap[1:] += u[:-1]
    lap[:-1] += u[1:]
    for axis in (1, 2):
        lap += np.roll(u, 1, axis=axis) + np.roll(u, -1, axis=axis)
    return lap


def residual_norm(u: np.ndarray, b: np.ndarray) -> float:
    """||b - A u|| over the global ``(nx, ny, nz)`` grid in float64 on the
    host: a solve's true residual, independent of its recursive one."""
    return float(np.linalg.norm(b.astype(np.float64) + laplacian_f64(u)))


def cg_setup(mesh, cfg: CGCfg, alpha: float = 0.125, *, rhs: np.ndarray | None = None
             ) -> tuple[torch.Tensor, GroupedMesh]:
    """A solve's set-up on this rank: this row's slab of the right-hand side
    (``rhs``, `cg_rhs` by default) on the mesh's device, and the mode's
    grouped mesh."""
    gmesh = cg_graph(mesh, cfg.mode, alpha)
    if rhs is None:
        rhs = cg_rhs(cfg, mesh.shape["data"], gmesh.compute.size)
    b = torch.from_numpy(np.ascontiguousarray(rhs[mesh.row])).to(mesh.device)
    return b, gmesh


def run_cg(mesh, cfg: CGCfg, alpha: float = 0.125, *, rhs: np.ndarray | None = None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's part of one solve: `cg_setup`, then the iterations.
    Returns this row's (u, residual norm, history); the residual and
    history are the compute group's, the same on every compute row."""
    b, gmesh = cg_setup(mesh, cfg, alpha, rhs=rhs)
    return cg_solve(b, cfg, gmesh)


def _cg_rank(mesh, cfg: CGCfg, modes: Sequence[str]) -> dict:
    out = {}
    for mode in modes:
        u, res, hist = run_cg(mesh, dataclasses.replace(cfg, mode=mode))
        out[mode] = (u.cpu().numpy(), float(res), hist.cpu().numpy())
    return out


def cg_world(cfg: CGCfg, modes: Sequence[str] = MODES, *, n_rows: int = 8,
             device=None) -> dict[str, tuple[np.ndarray, float, np.ndarray]]:
    """Host entry point: start an ``n_rows``-rank world (`launch.mesh.spawn`,
    on the card unless ``device`` names another), solve once per mode in
    it at `run_cg`'s defaults (the decoupled mode's halo row 1/8 of the
    rows), and return per mode what the reference's `run_cg` returns: (u of
    every row, ``(n_rows, nx_per, ny, nz)``; row 0's residual norm; row
    0's history)."""
    from repro_torch.launch.mesh import spawn

    ranks = spawn(_cg_rank, n_rows, device=device, args=(cfg, tuple(modes)), timeout_s=600.0)
    return {mode: (np.stack([r[mode][0] for r in ranks]), ranks[0][mode][1], ranks[0][mode][2])
            for mode in modes}


__all__ = ["CGCfg", "HALO", "MODES", "cg_graph", "cg_rhs", "cg_setup", "cg_solve", "cg_world",
           "laplacian_f64", "residual_norm", "run_cg"]
