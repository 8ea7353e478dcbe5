"""NN-descent k-NN-graph construction; port of
``raft_tpu/neighbors/nn_descent.py`` (analog of the reference's GNND,
``neighbors/detail/nn_descent.cuh``).

Each round, every node's candidates are its current neighbors, sampled
neighbors-of-neighbors and sampled reverse neighbors; one batched
product scores node against candidates, and a merge that drops repeated
ids keeps the k best. Reverse edges come from sort-and-rank packing
(:func:`_reverse_sample`, deterministic, equal to the JAX package's) or
from a random-slot scatter (:func:`_reverse_sample_random`, the per-round
sampler).

The random draws come from a ``torch.Generator`` seeded with
``params.seed`` on the data's device (the JAX package uses
``jax.random``): the two packages draw different numbers, so their
graphs agree in quality (recall), not bit for bit. On the card, a
colliding slot of the random reverse scatter keeps whichever write lands
last, so a build there is not bit-reproducible either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors._exact import gathered_distances, smallest_k


@dataclasses.dataclass(frozen=True)
class NNDescentParams:
    """Mirrors ``nn_descent::index_params`` (the JAX package's fields)."""

    graph_degree: int = 64
    intermediate_graph_degree: int = 128
    max_iterations: int = 20
    termination_threshold: float = 0.0001
    metric: DistanceType = DistanceType.L2Expanded
    sample_size: int = 16         # neighbors-of-neighbors fan-out per node
    # 2-hop pairs kept per node per round; 0 = all sample_size²
    hop2_sample: int = 0
    seed: int = 0


def _merge_dedup(ids: torch.Tensor, dists: torch.Tensor, k: int):
    """Sort candidates by id (stable), mask repeated ids and ids < 0,
    keep the k smallest distances, ties to the smallest id. (n, c) ->
    (n, k) ids (-1 where no finite distance) and distances."""
    order = torch.argsort(ids, dim=1, stable=True)
    sids = torch.gather(ids, 1, order)
    sdists = torch.gather(dists, 1, order)
    dup = torch.zeros_like(sids, dtype=torch.bool)
    dup[:, 1:] = sids[:, 1:] == sids[:, :-1]
    sdists = torch.where(dup | (sids < 0), torch.full_like(sdists,
                                                           float("inf")),
                         sdists)
    out_d, pos = smallest_k(sdists, k)
    out_ids = torch.gather(sids, 1, pos)
    out_ids = torch.where(torch.isfinite(out_d), out_ids,
                          torch.full_like(out_ids, -1))
    return out_ids, out_d


def _distances_to(dataset, node_ids, cand_ids, metric: DistanceType):
    """Exact metric between each node (t,) and its candidate rows (t, c)."""
    return gathered_distances(dataset[node_ids.to(torch.int64)], dataset,
                              cand_ids, metric)


def _reverse_sample(graph: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Sampled reverse graph: ``rev[j]`` holds up to r nodes i with
    j in ``graph[i]``, the first r by source id (sort-and-rank packing,
    no atomics; equal to the JAX package's)."""
    dev = graph.device
    deg = graph.shape[1]
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(deg)
    dst = graph.reshape(-1).to(torch.int64)
    dst_sort = torch.where(dst >= 0, dst, torch.full_like(dst, n))
    order = torch.argsort(dst_sort, stable=True)
    sdst = dst_sort[order]
    ssrc = src[order]
    first = torch.searchsorted(sdst, torch.arange(n, device=dev), side="left")
    rank = torch.arange(sdst.shape[0], device=dev) - first[sdst.clamp(0, n - 1)]
    slot = torch.where((sdst < n) & (rank < r), sdst * r + rank,
                       torch.full_like(sdst, n * r))
    flat = torch.full((n * r + 1,), -1, dtype=torch.int32, device=dev)
    flat[slot] = ssrc     # the slots below n*r are distinct
    return flat[: n * r].reshape(n, r)


def _reverse_sample_random(graph: torch.Tensor, n: int, r: int,
                           gen: torch.Generator) -> torch.Tensor:
    """Sampled reverse graph without the global edge sort: each edge
    writes its source into a random one of 2r slots of its destination's
    row (collisions drop edges: the sampling), then each row keeps its
    first r filled slots."""
    dev = graph.device
    r2 = 2 * r
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(
        graph.shape).reshape(-1)
    dst = graph.reshape(-1).to(torch.int64)
    slot_r = torch.randint(0, r2, dst.shape, generator=gen, device=dev)
    slot = torch.where(dst >= 0, dst * r2 + slot_r,
                       torch.full_like(dst, n * r2))
    flat = torch.full((n * r2 + 1,), -1, dtype=torch.int32, device=dev)
    flat[slot] = src
    rows = flat[: n * r2].reshape(n, r2)
    order = torch.argsort((rows < 0).to(torch.int8), dim=1, stable=True)
    return torch.gather(rows, 1, order[:, :r])


def _nn_descent_round(dataset, graph, dists, rev, gen: torch.Generator, *,
                      k: int, s: int, s2: int, metric: DistanceType,
                      tile: int):
    """One expansion round over all nodes, tile by tile. Returns the new
    graph, its distances and the number of changed entries. The tiles
    write disjoint rows and read only the round's start state."""
    n = dataset.shape[0]
    dev = dataset.device
    ranks = torch.randint(0, graph.shape[1], (n, s), generator=gen,
                          device=dev)
    sampled = torch.gather(graph, 1, ranks)                  # (n, s)
    cols = None
    if s2 < s * s:
        cols = torch.randperm(s * s, generator=gen, device=dev)[:s2]
    new_g = torch.empty_like(graph)
    new_d = torch.empty_like(dists)
    changed = torch.zeros((), dtype=torch.int64, device=dev)
    for start in range(0, n, tile):
        nid = torch.arange(start, min(start + tile, n), dtype=torch.int64,
                           device=dev)
        cur_ids, cur_d = graph[nid], dists[nid]
        hop1 = sampled[nid]                                  # (t, s)
        if cols is None:
            hop2 = sampled[hop1.clamp(min=0).to(torch.int64)]  # (t, s, s)
            hop2 = torch.where((hop1 >= 0)[:, :, None], hop2,
                               torch.full_like(hop2, -1)).reshape(
                                   nid.shape[0], -1)
        else:
            h1c = hop1[:, cols // s]                         # (t, s2)
            flat = h1c.clamp(min=0).to(torch.int64) * s + (cols % s)[None, :]
            hop2 = sampled.reshape(-1)[flat]
            hop2 = torch.where(h1c >= 0, hop2, torch.full_like(hop2, -1))
        cand = torch.cat([hop1, hop2, rev[nid]], dim=1)
        cand = torch.where(cand == nid[:, None], torch.full_like(cand, -1),
                           cand)                             # no self loops
        cd = _distances_to(dataset, nid, cand, metric)
        ids, dd = _merge_dedup(torch.cat([cur_ids, cand], dim=1),
                               torch.cat([cur_d, cd], dim=1), graph.shape[1])
        changed += (ids != cur_ids).sum()
        new_g[nid] = ids
        new_d[nid] = dd
    return new_g, new_d, changed


def build(res: Optional[Resources], params: NNDescentParams, dataset,
          return_distances: bool = False, init_graph=None):
    """Build an approximate k-NN graph (``nn_descent::build``): (n,
    graph_degree) int32 without self edges, optionally with distances.

    ``init_graph``: optional (n, w) int32 candidate ids (-1 empty) that
    seed the working graph instead of pure random init; -1 slots and
    columns past w are topped up with random ids."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    n = dataset.shape[0]
    k = params.intermediate_graph_degree
    expect(params.graph_degree <= k,
           "graph_degree must be <= intermediate_graph_degree")
    expect(k < n, "intermediate_graph_degree must be < n_rows")
    expect(params.metric in (DistanceType.L2Expanded,
                             DistanceType.L2SqrtExpanded,
                             DistanceType.InnerProduct),
           f"nn_descent supports L2/InnerProduct, got {params.metric!r}")
    metric = (DistanceType.InnerProduct
              if params.metric == DistanceType.InnerProduct
              else DistanceType.L2Expanded)
    ds32 = dataset.to(torch.float32)
    dev = ds32.device

    with tracing.range("raft_tpu.nn_descent.build"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(params.seed)
        rows = torch.arange(n, device=dev)[:, None]
        init = torch.randint(0, n - 1, (n, k), generator=gen, device=dev)
        init = torch.where(init >= rows, init + 1, init)
        if init_graph is not None:
            seed_ids = res.put(init_graph, torch.int64)
            expect(seed_ids.ndim == 2 and seed_ids.shape[0] == n,
                   "init_graph must be (n, w)")
            w = min(seed_ids.shape[1], k)
            merged = torch.cat([seed_ids[:, :w], init[:, w:]], dim=1)
            merged = torch.where(merged >= 0, merged, init)
            init = torch.where(merged == rows, torch.full_like(merged, -1),
                               merged)
        init = init.to(torch.int32)
        # nodes per tile bound the (tile, c, d) gather buffer (the JAX
        # package's formula)
        tile = max(64, min(1024, (1 << 22) // max(k * 4, 1)))
        d0 = torch.cat([
            _distances_to(ds32, torch.arange(s, min(s + tile, n), device=dev),
                          init[s: s + tile], metric)
            for s in range(0, n, tile)])
        graph, dists = _merge_dedup(init, d0, k)

        s = min(params.sample_size, k)
        s2 = s * s if params.hop2_sample <= 0 else min(params.hop2_sample,
                                                       s * s)
        total = n * k
        for _ in range(params.max_iterations):
            rev = _reverse_sample_random(graph, n, s, gen)
            graph, dists, changed = _nn_descent_round(
                ds32, graph, dists, rev, gen, k=k, s=s, s2=s2, metric=metric,
                tile=tile)
            if float(changed) / total < params.termination_threshold:
                break

        out = graph[:, : params.graph_degree]
        if not return_distances:
            return out
        out_d = dists[:, : params.graph_degree]
        if params.metric == DistanceType.InnerProduct:
            out_d = -out_d
        elif params.metric == DistanceType.L2SqrtExpanded:
            out_d = torch.sqrt(torch.clamp(out_d, min=0.0))
        return out, out_d
