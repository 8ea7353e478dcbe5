"""List-major IVF probe scan — the port of ``raft_tpu/ops/ivf_scan.py``.

Two engines share one contract (``list_major_scan``): the pre-epilog
running top-k ``(best_d, best_i)`` per query over the lists it probed —
min-space ``norms - 2 x.y`` for L2 with +inf pads, raw inner products
for IP with -inf pads — with ties broken by the smallest dataset id, id
-1 in unfilled slots, and probe slots that carry the sentinel id
``n_lists`` ignored.

- ``cuda``: the hand-written kernel ``csrc/ivf_scan.cu``, which replaces
  the JAX package's Pallas kernel ``_ivf_scan_kernel`` (reached through
  ``_scan_pallas`` / ``list_major_scan``). The wrapper turns the probes
  into (list, query) pairs grouped by list and plans work items on the
  device (:func:`_scan_items`): (list, chunk of its live rows, group of
  up to 64 of the queries that probed it), so no query is scored against
  a list it did not probe and a long list spreads over many blocks. A
  first kernel finds each query's seed bound (:func:`_seed_steps`); the
  items write one partial top-k per (query, probe slot, chunk), which a
  ragged merge reduces per query. On the H100 the scan is bound by
  float32 CUDA-core arithmetic at large batches (PERF.md).
- ``rank``: :func:`rank_major_scan`, the legacy rank-major gather scan
  of the JAX package's ``scan_engine="rank"`` (``ivf_flat.py:532-562``):
  for each probe rank, every query's list gathered and scored by one
  batched product, then merged by ``merge_topk``. Plain PyTorch on every
  device, kept for parity with the JAX ``rank`` engine.
- ``torch``: the plain version, the twin of the JAX package's
  ``_scan_xla`` (``ivf_scan.py:298-359``): a loop over the probed-list
  union with one matmul per list and ``_merge_smallest_id``'s
  lexicographic merge. It is what CPU tensors run, and the documented
  exceptions route here before any launch (see
  :func:`resolve_scan_engine`).

``list_major_scan.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors.filters import test_filter

SCAN_ENGINES = ("auto", "cuda", "torch", "rank")

#: largest k the kernel takes (its per-query lists live in shared memory)
CUDA_MAX_K = 128


def resolve_scan_engine(engine: str, *, data=None, filter_words=None,
                        k=None) -> str:
    """Resolve a ``scan_engine`` search param to ``cuda`` or ``torch``.

    ``auto`` is the CUDA kernel when the index lies on a CUDA device and
    the plain engine otherwise. ``cuda`` goes to ``torch`` where the
    kernel does not apply, as the JAX package sends ``pallas`` to
    ``xla``: per-query (2-D) filter words (the id fold needs one shared
    id plane), k past :data:`CUDA_MAX_K`, and storage other than
    float32/bfloat16. It decides before any launch, never after a
    failure. ``rank`` (:func:`rank_major_scan`) passes through."""
    expect(engine in SCAN_ENGINES,
           f"scan_engine must be one of {SCAN_ENGINES}, got {engine!r}")
    if engine == "auto":
        on_cuda = (data.device.type == "cuda" if data is not None
                   else torch.cuda.is_available())
        engine = "cuda" if on_cuda else "torch"
    if engine != "cuda":
        return engine
    if filter_words is not None and filter_words.ndim == 2:
        return "torch"
    if k is not None and k > CUDA_MAX_K:
        return "torch"
    if data is not None and data.dtype not in (torch.float32, torch.bfloat16):
        return "torch"
    return engine


def probe_histogram(probes: torch.Tensor, counts: torch.Tensor,
                    n_valid=None) -> torch.Tensor:
    """``counts`` plus a ``bincount`` of the probed list ids: the
    per-list traffic window that tiered placement reads. ``probes`` is
    the (q, n_probes) selection, ``counts`` the (n_lists,) running plane;
    rows at and past ``n_valid`` (pad rows) count nothing. Ids outside
    the list range (the sentinel ``n_lists``) are dropped, and negative
    ids count from the end, as the JAX package's ``.at[].add(mode="drop")``
    does. Returns a new plane of ``counts``' type."""
    n_lists = counts.shape[0]
    ids = probes.to(torch.int64)
    if n_valid is not None:
        valid = torch.arange(ids.shape[0], device=ids.device) < n_valid
        ids = torch.where(valid[:, None], ids, n_lists)
    ids = ids.reshape(-1)
    ids = torch.where(ids < 0, ids + n_lists, ids)
    # every dropped id lands in one extra bin: no data-dependent shape
    # (a mask or bincount reads the data on the host), so the plane
    # updates inside a captured CUDA graph
    ids = torch.where((ids >= 0) & (ids < n_lists), ids,
                      torch.full_like(ids, n_lists))
    hist = torch.zeros(n_lists + 1, dtype=torch.int64, device=ids.device)
    hist.scatter_add_(0, ids, torch.ones_like(ids))
    return counts + hist[:n_lists].to(counts.dtype)


def ragged_row_probes(sizes, n_probes_list, tile: int):
    """Expand one packed tile's per-request row ranges into the per-ROW
    probe-budget plane (host side): rows of request ``j`` carry
    ``n_probes_list[j]``; rows past ``sum(sizes)`` are padding with
    budget 0. Returns a ``(tile,)`` int32 numpy array."""
    out = np.zeros((tile,), np.int32)
    row = 0
    for m, p in zip(sizes, n_probes_list):
        out[row:row + m] = p
        row += m
    expect(row <= tile, f"packed rows {row} overflow the tile {tile}")
    return out


def ragged_probes(probes: torch.Tensor, row_probes: torch.Tensor,
                  n_lists: int) -> torch.Tensor:
    """Mask each row's probe slots past its own budget to the sentinel
    id ``n_lists``."""
    slot = torch.arange(probes.shape[1], device=probes.device)
    row_probes = torch.as_tensor(row_probes, device=probes.device)
    return torch.where(slot[None, :] < row_probes[:, None], probes,
                       torch.full_like(probes, n_lists))


def ragged_owned(mine: torch.Tensor, row_probes: torch.Tensor,
                 shards: int = 1) -> torch.Tensor:
    """Fold a packed ragged tile's per-row probe budgets into a sharded
    probe-ownership mask (``raft_tpu/ops/ivf_scan.py:214``), the mesh
    half of the ragged front: ``mine`` is
    :func:`raft_tpu_torch.distributed.ivf.select_probes_sharded`'s
    (row, probe rank) mask, whose columns follow the exact coarse top-k
    (a total order, so a row's first ``b`` columns are the solo
    ``n_probes=b`` selection). A row keeps only its slots below its
    budget; ``shards`` turns the global budget into the per-shard one of
    ``probe_mode="local"`` (``ceil(b / R)``). Pad rows (budget 0) own
    nothing."""
    slot = torch.arange(mine.shape[1], device=mine.device)
    budget = torch.as_tensor(row_probes, device=mine.device)
    if shards > 1:
        budget = -torch.div(-budget, shards, rounding_mode="floor")
    return mine & (slot[None, :] < budget[:, None])


def unique_lists(probes: torch.Tensor, n_lists: int) -> torch.Tensor:
    """Sorted union of probed list ids, padded to the static cap
    ``min(n_lists, q * n_probes)`` with the sentinel id ``n_lists``.
    Probe slots carrying the sentinel collapse into the sentinel steps."""
    q, p = probes.shape
    cap = min(n_lists, q * p)
    flat = torch.sort(probes.reshape(-1).to(torch.int64)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    # every value is scattered: a first occurrence to its rank, a repeat
    # (and a rank past the cap) to one extra slot that is then dropped.
    # No mask indexing, so no data-dependent shape: the union is planned
    # on the device without a host sync (and inside a CUDA graph)
    slot = torch.where(first, rank.clamp(max=cap), torch.full_like(rank, cap))
    uniq = torch.full((cap + 1,), n_lists, dtype=torch.int64,
                      device=probes.device)
    uniq.scatter_(0, slot, flat)
    return uniq[:cap].to(torch.int32)


def sorted_probes(probes: torch.Tensor, n_lists: int) -> torch.Tensor:
    """Each row's probes sorted by list id (int64), with out-of-range
    slots and repeats of a list turned into the sentinel ``n_lists``."""
    pr = probes.to(torch.int64)
    pr = torch.where((pr < 0) | (pr >= n_lists), torch.full_like(pr, n_lists),
                     pr)
    pr = torch.sort(pr, dim=1).values
    dup = torch.zeros_like(pr, dtype=torch.bool)
    dup[:, 1:] = pr[:, 1:] == pr[:, :-1]
    return torch.where(dup, torch.full_like(pr, n_lists), pr)


def union_id_planes(indices: torch.Tensor, uniq: torch.Tensor,
                    filter_words=None) -> torch.Tensor:
    """The id planes of the probed-list union ``uniq`` (sentinel slots
    read the last list); a shared (1-D) filter folds in, as in the JAX
    package's engines: a filtered slot becomes id -1, i.e. padding."""
    n_lists = indices.shape[0]
    ids_g = indices[uniq.clamp(max=n_lists - 1).to(torch.int64)]
    if filter_words is not None:
        keep = test_filter(filter_words.to(ids_g.device), ids_g) & (ids_g >= 0)
        ids_g = torch.where(keep, ids_g, torch.full_like(ids_g, -1))
    return ids_g


def live_rows(ids_g: torch.Tensor) -> torch.Tensor:
    """(n,) int32: each (n, m) id plane's rows up to its last live one
    (id >= 0), 0 for a plane with none. The rows past it are padding or
    filtered, which no scan reads: the extent the kernels of the tiered
    and IVF-BQ scans walk and stage."""
    pos = torch.arange(1, ids_g.shape[1] + 1, dtype=torch.int32,
                       device=ids_g.device)
    return torch.where(ids_g >= 0, pos, torch.zeros_like(pos)).amax(dim=1)


def list_major_scan(qf, data, data_norms, indices, probes, filter_words=None,
                    *, k: int, metric: DistanceType, engine: str = "torch"):
    """Run the probe scan list-major; returns the pre-epilog top-k
    ``(best_d, best_i)``, (q, k) float32 and int32 (see the module
    docstring). ``engine`` is resolved (``cuda`` or ``torch``): CPU
    tensors always take the plain engine."""
    expect(engine in ("cuda", "torch"),
           f"list_major_scan engine must be cuda|torch, got {engine!r}")
    if engine == "torch" or data.device.type == "cpu":
        return _scan_torch(qf, data, data_norms, indices, probes,
                           filter_words, k=k, metric=metric)
    return _scan_cuda(qf, data, data_norms, indices, probes, filter_words,
                      k=k, metric=metric)


def rank_major_scan(qf, data, data_norms, indices, probes,
                    filter_words=None, *, k: int, metric: DistanceType,
                    valid=None):
    """The rank-major engine, the twin of the JAX ``rank`` engine: for
    each probe rank, every query's list gathered ((q, m, d)), scored by one
    batched product and merged into the running top-k by ``merge_topk``
    (stable: the running state first on ties). Returns the pre-epilog
    ``(best_d, best_i)`` of the module docstring, with -1 ids where a
    slot held padding, and IP pads at -inf. ``valid`` ((q, p) bool, the
    mesh shard bodies' ownership mask) pads every row of a slot it
    clears."""
    from raft_tpu_torch.matrix.select_k import merge_topk

    q, p = probes.shape
    n_lists = data.shape[0]
    ip_metric = metric == DistanceType.InnerProduct
    pad_val = float("-inf") if ip_metric else float("inf")
    qf = qf.to(torch.float32)
    best_d = qf.new_full((q, k), pad_val)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=qf.device)
    for r in range(p):
        lists = probes[:, r].to(torch.int64).clamp(0, n_lists - 1)
        rows = data[lists].to(torch.float32)                # (q, m, d)
        row_ids = indices[lists]                             # (q, m)
        ipr = torch.bmm(rows, qf[:, :, None])[:, :, 0]       # (q, m)
        dist = ipr if ip_metric else data_norms[lists] - 2.0 * ipr
        ok = row_ids >= 0
        if valid is not None:
            ok = ok & valid[:, r][:, None]
        if filter_words is not None:
            ok = ok & test_filter(filter_words, row_ids)
        dist = torch.where(ok, dist, torch.full_like(dist, pad_val))
        best_d, best_i = merge_topk(best_d, best_i, dist, row_ids, k,
                                    not ip_metric)
    return best_d, best_i


# ---------------------------------------------------------------------------
# plain engine
# ---------------------------------------------------------------------------


def _merge_smallest_id(best_d, best_i, dist, ids, k: int):
    """Min-space running top-k merge in (distance, smallest id) order —
    ``_merge_smallest_id``'s lexicographic two-key sort as two stable
    sorts (id, then distance)."""
    cat_d = torch.cat([best_d, dist], dim=1)
    cat_i = torch.cat([best_i, ids], dim=1)
    o1 = torch.sort(cat_i, dim=1, stable=True).indices
    cat_d = torch.gather(cat_d, 1, o1)
    cat_i = torch.gather(cat_i, 1, o1)
    sd, o2 = torch.sort(cat_d, dim=1, stable=True)
    sd, si = sd[:, :k], torch.gather(cat_i, 1, o2[:, :k])
    return sd, torch.where(torch.isfinite(sd), si, torch.full_like(si, -1))


def _scan_torch(qf, data, data_norms, indices, probes, filter_words, *,
                k: int, metric: DistanceType):
    q = qf.shape[0]
    n_lists = data.shape[0]
    ip_metric = metric == DistanceType.InnerProduct
    qf = qf.to(torch.float32)
    best_d = qf.new_full((q, k), float("inf"))
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=qf.device)
    # sentinel steps match no query: only real lists change the state
    for lid in unique_lists(probes, n_lists).tolist():
        if lid >= n_lists:
            continue
        ip = qf @ data[lid].to(torch.float32).T                 # (q, m)
        dist = -ip if ip_metric else data_norms[lid][None, :] - 2.0 * ip
        ids_b = indices[lid][None, :].expand(q, -1)
        probed = (probes == lid).any(dim=1)                      # (q,)
        ok = (ids_b >= 0) & probed[:, None]
        if filter_words is not None:
            ok = ok & test_filter(filter_words, ids_b)
        dist = torch.where(ok, dist, torch.full_like(dist, float("inf")))
        best_d, best_i = _merge_smallest_id(best_d, best_i, dist, ids_b, k)
    if ip_metric:
        best_d = -best_d          # inf (unfilled) -> -inf, ip exact
    return best_d, best_i


# ---------------------------------------------------------------------------
# CUDA engine
# ---------------------------------------------------------------------------

_QUERY_GROUP = 64   # queries per work item in csrc/ivf_scan_body.cuh
_CHUNK_ROWS = 512   # list rows per work item (kChunkRows)


def _scan_pairs(probes: torch.Tensor, n_lists: int):
    """(list, query) pairs grouped by list, as the kernel consumes them:
    the probed-list union ``uniq``, CSR offsets into the list-sorted pairs,
    and each pair's query row and probe slot. A row's repeated probe of
    one list and sentinel slots form no pair; they sort after every real
    pair (``offs[-1]`` is the pair count)."""
    q, p = probes.shape
    pr = sorted_probes(probes, n_lists)
    uniq = unique_lists(pr, n_lists)
    cap = uniq.shape[0]
    rows = torch.arange(q, device=pr.device)[:, None]
    skey, order = torch.sort((pr * q + rows).reshape(-1))
    pair_lid = skey // q
    j = torch.searchsorted(uniq.to(torch.int64), pair_lid)
    j = torch.where(pair_lid < n_lists, j, torch.full_like(j, cap))
    counts = torch.zeros(cap + 1, dtype=torch.int64, device=pr.device)
    counts.scatter_add_(0, j, torch.ones_like(j))
    offs = torch.zeros(cap + 1, dtype=torch.int64, device=pr.device)
    offs[1:] = torch.cumsum(counts[:cap], 0)
    return (uniq, offs.to(torch.int32), (skey % q).to(torch.int32),
            (order % p).to(torch.int32))


def _scan_items(offs, pair_q, pair_slot, live, q: int, p: int,
                chunk: int = _CHUNK_ROWS, group: int = _QUERY_GROUP):
    """The work-item plan of the scan kernels, on the pairs' device with
    no host sync: (list, chunk of ``chunk`` of its ``live`` rows, group of
    ``group`` of its probing pairs); the IVF-Flat kernels take the
    defaults, the IVF-PQ kernel its own (``ops/ivf_pq_scan``).

    Returns ``items`` (cap,) int64, each union step's item count;
    ``item_off`` (cap + 1,) int64, the first item of each step; and
    ``slot_off`` (q * p + 1,) int32, the first partial list of each
    (query, probe slot): a pair gets one partial per chunk of its list,
    a sentinel or repeated slot none, so query r owns the partials
    ``slot_off[r * p] .. slot_off[(r + 1) * p]``."""
    cap = live.shape[0]
    dev = live.device
    cnt = (offs[1:] - offs[:-1]).to(torch.int64)
    nch = -(-live.to(torch.int64) // chunk)
    items = nch * -(-cnt // group)
    item_off = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    item_off[1:] = torch.cumsum(items, 0)
    # pair e lies in list j with offs[j] <= e < offs[j + 1]
    e = torch.arange(q * p, dtype=torch.int64, device=dev)
    j = torch.searchsorted(offs[1:].to(torch.int64), e, right=True)
    per_pair = torch.cat([nch, nch.new_zeros(1)])[j]   # j == cap: no list
    # every (query, slot) is one flattened entry: each gets written once
    grid = torch.zeros(q * p, dtype=torch.int64, device=dev)
    grid[pair_q.to(torch.int64) * p + pair_slot.to(torch.int64)] = per_pair
    slot_off = torch.zeros(q * p + 1, dtype=torch.int64, device=dev)
    slot_off[1:] = torch.cumsum(grid, 0)
    return items, item_off, slot_off.to(torch.int32)


def _seed_steps(probes: torch.Tensor, uniq: torch.Tensor, n_lists: int,
                usable=None) -> torch.Tensor:
    """(q,) int32: the union step of each row's first probe of a real list
    (and, with ``usable``, an (n_lists,) bool plane, of a usable one), -1
    for a row with none: the list whose first rows give the kernels' seed
    bound (``csrc/ivf_scan_body.cuh``, ``seed_bounds``)."""
    pr = probes.to(torch.int64)
    ok = (pr >= 0) & (pr < n_lists)
    if usable is not None:
        ok = ok & usable[pr.clamp(0, n_lists - 1)]
    first = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
    j = torch.searchsorted(uniq.to(torch.int64), torch.gather(pr, 1, first))
    return torch.where(ok.any(dim=1), j[:, 0],
                       torch.full_like(j[:, 0], -1)).to(torch.int32)


def _launch_glue(qf, indices, probes, filter_words, k: int, usable=None):
    """What both scan kernels (this one and ``csrc/tier_scan.cu``) take
    besides the rows: float32 queries, the (list, query) pairs of
    :func:`_scan_pairs`, the union's id planes with a shared filter
    folded in and their live rows, the work-item plan of
    :func:`_scan_items`, the partial lists (a bound of ``q * n_probes *
    ceil(m / _CHUNK_ROWS)`` lists of k, uninitialized: the kernel writes
    every one it merges), each row's seed list (:func:`_seed_steps`, of a
    ``usable`` list) with room for its bound, and the (q, k) outputs."""
    q, p = probes.shape
    m = indices.shape[1]
    dev = qf.device
    uniq, offs, pair_q, pair_slot = _scan_pairs(probes, indices.shape[0])
    ids_g = union_id_planes(indices, uniq, filter_words).to(
        torch.int32).contiguous()
    live = live_rows(ids_g)
    items, item_off, slot_off = _scan_items(offs, pair_q, pair_slot, live,
                                            q, p)
    n_part = q * p * -(-m // _CHUNK_ROWS) * k
    pd = torch.empty((n_part,), dtype=torch.float32, device=dev)
    pi = torch.empty((n_part,), dtype=torch.int32, device=dev)
    outd = torch.empty((q, k), dtype=torch.float32, device=dev)
    outi = torch.empty((q, k), dtype=torch.int32, device=dev)
    return dict(qf=qf.to(torch.float32).contiguous(), uniq=uniq, offs=offs,
                pair_q=pair_q, pair_slot=pair_slot, ids_g=ids_g, live=live,
                items=items, item_off=item_off, slot_off=slot_off,
                seed_step=_seed_steps(probes, uniq, indices.shape[0], usable),
                bound_d=torch.empty((q,), dtype=torch.float32, device=dev),
                bound_i=torch.empty((q,), dtype=torch.int32, device=dev),
                pd=pd, pi=pi, outd=outd, outi=outi)


def _scan_cuda(qf, data, data_norms, indices, probes, filter_words, *,
               k: int, metric: DistanceType):
    dev = data.device
    q, d = qf.shape
    n_lists, m, _ = data.shape
    p = probes.shape[1]
    expect(all(t.device == dev for t in (qf, data_norms, indices, probes)),
           "list_major_scan: all inputs must be on the data's device")
    expect(data.dtype in (torch.float32, torch.bfloat16),
           f"list_major_scan: kernel takes float32/bfloat16 data, got "
           f"{data.dtype}")
    expect(data.is_contiguous() and data_norms.is_contiguous()
           and indices.is_contiguous(),
           "list_major_scan: data, norms and indices must be contiguous")
    expect(data_norms.shape == (n_lists, m) and indices.shape == (n_lists, m)
           and data.shape[2] == d, "list_major_scan: shape mismatch")
    expect(0 < k <= CUDA_MAX_K,
           f"list_major_scan: kernel takes 0 < k <= {CUDA_MAX_K}, got {k}")
    expect(filter_words is None or filter_words.ndim == 1,
           "list_major_scan: kernel takes a shared (1-D) filter only")
    from raft_tpu_torch.ops import _build

    launch = _build.load("ivf_scan")
    g = _launch_glue(qf, indices, probes, filter_words, k)
    cap = g["uniq"].shape[0]
    # a host bound on the item count sizes the grid (no sync)
    max_items = cap * -(-m // _CHUNK_ROWS) * -(-q // _QUERY_GROUP)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(g["qf"].data_ptr(), data.data_ptr(),
                 int(data.dtype == torch.bfloat16), data_norms.data_ptr(),
                 *(g[n].data_ptr() for n in (
                     "ids_g", "uniq", "offs", "pair_q", "pair_slot", "live",
                     "item_off", "slot_off")),
                 q, p, d, m, k, int(metric == DistanceType.InnerProduct),
                 cap, max_items,
                 *(g[n].data_ptr() for n in ("seed_step", "bound_d",
                                             "bound_i", "pd", "pi", "outd",
                                             "outi")),
                 stream)
    _build.check(err, "list_major_scan")
    list_major_scan.launches += 1
    return g["outd"], g["outi"]


list_major_scan.launches = 0
