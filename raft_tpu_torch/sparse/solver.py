"""Sparse solvers — port of ``raft_tpu/sparse/solver.py`` (reference
``raft/sparse/solver/``): parallel Borůvka MST (``mst_solver.cuh``,
``detail/mst_solver_inl.cuh``) and the Lanczos smallest-eigenvector
solver (``lanczos.cuh:68`` ``computeSmallestEigenvectors``).

Borůvka as in the JAX package: the reference's per-vertex atomic min-edge
kernels become segment mins over the edge list (``scatter_reduce``), and
supervertex contraction becomes pointer jumping on a label tensor; every
round is the same fixed sequence of tensor ops, ``ceil(log2 n)`` rounds,
because components at least halve. The JAX package's ``fori_loop``s are
Python loops over tensors on the device, with no host read inside.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.sparse.types import CSR, _lexsort, _segment_min

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class MSTResult:
    """``Graph_COO`` result of the MST solver (src/dst/weights) plus the
    per-vertex component color (``mst_solver_t::solve`` outputs)."""

    src: torch.Tensor      # (n_edges_cap,) int32, -1 padding
    dst: torch.Tensor
    weights: torch.Tensor
    color: torch.Tensor    # (n,) final component label per vertex
    n_edges: int           # valid edge count

    @property
    def total_weight(self) -> float:
        w = torch.where(self.src >= 0, self.weights,
                        torch.zeros_like(self.weights))
        return float(torch.sum(w))


def _boruvka(u, v, w, rank, n: int, rounds: int):
    """(component per vertex, edge-in-forest mask) after ``rounds``
    Borůvka rounds over the directed edge copies (u, v) with their
    shared undirected ``rank``."""
    e = u.shape[0]
    dev = u.device
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    ui = u.clamp(min=0).to(torch.int64)
    vi = v.clamp(min=0).to(torch.int64)
    comp = ar.clone()
    in_mst = torch.zeros((e,), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        cu = comp[ui]
        cv = comp[vi]
        alive = (cu != cv) & (u >= 0)
        key = torch.where(alive, rank, _INT32_MAX)
        # min outgoing edge rank per component (both directions)
        minkey = torch.minimum(_segment_min(key, cu, n),
                               _segment_min(key, cv, n))
        cu64, cv64 = cu.to(torch.int64), cv.to(torch.int64)
        sel_u = alive & (rank == minkey[cu64])
        sel_v = alive & (rank == minkey[cv64])
        in_mst |= sel_u | sel_v

        # hooking: each component points at its min-edge partner (the
        # dummy slot n takes the unselected edges and is sliced off)
        partner = torch.cat([ar, ar.new_zeros(1)])
        partner[torch.where(sel_u, cu64, n)] = torch.where(sel_u, cv, 0)
        partner[torch.where(sel_v, cv64, n)] = torch.where(sel_v, cu, 0)
        partner = partner[:n]
        # break 2-cycles toward the smaller label
        two_cycle = partner[partner.to(torch.int64)] == ar
        par = torch.where(two_cycle & (ar < partner), ar, partner)
        # pointer jumping to forest roots
        for _ in range(max(1, rounds)):
            par = par[par.to(torch.int64)]
        comp = par[comp.to(torch.int64)]
    return comp, in_mst


def mst(
    res: Optional[Resources],
    adjacency: CSR,
) -> MSTResult:
    """Minimum spanning forest of a (symmetric, weighted) CSR graph —
    ``solver::mst`` (``mst_solver.cuh``). Deterministic: ties broken by a
    global weight-rank ordering (the reference's alteration trick,
    ``detail/mst_solver_inl.cuh``)."""
    ensure_resources(res)
    n = adjacency.shape[0]
    dev = adjacency.device
    r = adjacency.row_ids()
    u = torch.where(r >= 0, r, -1)
    v = adjacency.indices
    w = adjacency.data.to(torch.float32)
    e = u.shape[0]

    with tracing.range("raft_tpu.sparse.mst"):
        # canonical rank: (weight, lo, hi) lexicographic; the two directed
        # copies of an undirected edge share the lower rank
        lo = torch.minimum(u, v)
        hi = torch.maximum(u, v)
        order = _lexsort((hi, lo, w))
        ar = torch.arange(e, dtype=torch.int32, device=dev)
        rank = torch.empty((e,), dtype=torch.int32, device=dev)
        rank[order] = ar
        srt = _lexsort((hi, lo))
        rank_srt = rank[srt]
        lo_s, hi_s = lo[srt], hi[srt]
        same_prev = torch.cat([
            torch.zeros((1,), dtype=torch.bool, device=dev),
            (lo_s[1:] == lo_s[:-1]) & (hi_s[1:] == hi_s[:-1])])
        pair_min = torch.minimum(
            rank_srt, torch.where(same_prev, torch.roll(rank_srt, 1),
                                  rank_srt))
        rank[srt] = pair_min
        rank = torch.where(u >= 0, rank, _INT32_MAX)

        rounds = max(1, math.ceil(math.log2(max(n, 2))))
        comp, in_mst = _boruvka(u, v, w, rank, n, rounds)

        # emit each undirected MST edge once (first copy in (lo, hi) order)
        in_srt = in_mst[srt]
        dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                         same_prev[1:] & in_srt[:-1]])
        first_copy = torch.empty_like(in_mst)
        first_copy[srt] = ~dup
        emit = in_mst & first_copy
        return MSTResult(src=torch.where(emit, u, -1),
                         dst=torch.where(emit, v, 0),
                         weights=torch.where(emit, w, torch.zeros_like(w)),
                         color=comp, n_edges=int(emit.sum()))


def _cpu_normals(seed: int, count: int, n: int) -> torch.Tensor:
    """(count, n) float32 standard normals from a CPU generator seeded by
    ``seed``: the same draws whatever device the solver runs on."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    return torch.randn((count, n), generator=g)


def lanczos_smallest(
    res: Optional[Resources],
    a: CSR,
    k: int,
    max_iter: int = 0,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest eigenpairs of a symmetric sparse matrix —
    ``sparse::solver::lanczos`` ``computeSmallestEigenvectors``
    (``lanczos.cuh:68``). Lanczos with full reorthogonalization; the
    tridiagonal eigenproblem is solved densely (role of the reference's
    LAPACK steqr call).

    The start vector and the restart vectors (one an iteration, used on
    breakdown) are drawn on the CPU from a generator seeded by ``seed``
    and moved to the matrix's device: a card run and a CPU run start from
    the same vectors.

    Returns (eigenvalues (k,), eigenvectors (n, k))."""
    from raft_tpu_torch.sparse.linalg import spmv

    ensure_resources(res)
    n = a.shape[0]
    dev = a.device
    m = min(n, max_iter or max(4 * k + 8, 32))

    with tracing.range("raft_tpu.sparse.lanczos"):
        draws = _cpu_normals(seed, m + 1, n).to(dev)
        vmat = torch.zeros((m + 1, n), dtype=torch.float32, device=dev)
        vmat[0] = draws[0] / torch.linalg.vector_norm(draws[0])
        alpha = torch.zeros((m,), dtype=torch.float32, device=dev)
        beta = torch.zeros((m,), dtype=torch.float32, device=dev)
        for j in range(m):
            vj = vmat[j]
            wv = spmv(a, vj).to(torch.float32)
            aj = torch.dot(vj, wv)
            wv = wv - aj * vj
            if j > 0:
                wv = wv - beta[j - 1] * vmat[j - 1]
            # full reorthogonalization against all previous vectors
            basis = vmat[:j + 1]
            wv = wv - basis.T @ (basis @ wv)
            bj = torch.linalg.vector_norm(wv)
            # breakdown (invariant subspace exhausted): restart with a
            # fresh random vector orthogonalized against the basis, and
            # record beta=0 so T decouples into blocks — the reference's
            # LAPACK-restart behavior; without this, un-run iterations
            # would inject spurious zero eigenvalues
            breakdown = bj <= 1e-6
            rv = draws[j + 1]
            for _ in range(2):
                rv = rv - basis.T @ (basis @ rv)
            rv = rv / torch.clamp(torch.linalg.vector_norm(rv), min=1e-30)
            vmat[j + 1] = torch.where(breakdown, rv,
                                      wv / torch.clamp(bj, min=1e-30))
            alpha[j] = aj
            beta[j] = torch.where(breakdown, torch.zeros_like(bj), bj)

        t = (torch.diag(alpha) + torch.diag(beta[: m - 1], 1)
             + torch.diag(beta[: m - 1], -1))
        evals, evecs = torch.linalg.eigh(t)
        eigvecs = vmat[:m].T @ evecs[:, :k]
        # normalize (guard rank deficiency)
        norms = torch.linalg.vector_norm(eigvecs, dim=0)
        eigvecs = eigvecs / torch.clamp(norms, min=1e-30)
        return evals[:k], eigvecs
