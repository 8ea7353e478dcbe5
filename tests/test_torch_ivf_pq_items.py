"""A CPU model of the list-major IVF-PQ kernel's work items
(``csrc/ivf_pq_scan.cu``): the plan that ``ops/ivf_pq_scan._pq_items``
builds on the device, item by item, against the plain engine bit for
bit and against the JAX package's ``xla`` engine.

An item is (probed list, chunk of ``rows`` live rows, group of ``group``
probing (query, probe slot) pairs); it writes one partial top-k for each
of its pairs and its chunk at ``slot_off[query * p + slot] + chunk``, and
each query's partials are merged by (distance, smallest id). The model
scores each row by the kernel's summation order (``_kernel_row_sum`` of
``test_torch_ivf_pq``; with ``pass_bits`` > 0 as a table is scored in
``2^pass_bits`` parts, the order of the per-pair instance that takes
tables too large for the list-major block).

Exactness: as in ``test_torch_ivf_pq`` — the same sums in the same
order, so ids and distances equal the plain engine's bit for bit; on the
integer-valued JAX indexes ids equal and distances agree to float32
rounding (rtol 1e-6).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ivf_pq as pq_tests
from raft_tpu.neighbors import ivf_pq as j_pq
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_pq as t_pq
from raft_tpu_torch.ops import ivf_pq_scan as t_scan

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)


def _items(plan, rows: int, group: int):
    """Decode every work item as the kernel does: (list, first pair,
    pairs, chunk, first row, rows)."""
    offs, item_off, live = plan["offs"], plan["item_off"], plan["live"]
    out = []
    for it in range(int(item_off[-1])):
        lid = int(np.searchsorted(item_off.numpy(), it, side="right")) - 1
        t = it - int(item_off[lid])
        cnt_all = int(offs[lid + 1] - offs[lid])
        ngr = -(-cnt_all // group)
        chunk, grp = divmod(t, ngr)
        r0 = chunk * rows
        out.append((lid, int(offs[lid]) + grp * group,
                    min(group, cnt_all - grp * group), chunk, r0,
                    min(rows, int(live[lid]) - r0)))
    return out


def _emulate_items(qres, base, codebooks, cb_norms, codes, indices, probes,
                   fw, *, k, ip_metric, per_cluster, lut_dtype, packed,
                   rows, group, pass_bits=0):
    """The kernel's decomposition on the CPU: items planned by the
    wrapper's own planning function, each pair's LUT, each chunk row's
    score by ``_kernel_row_sum``, one partial a (pair, chunk) written
    once, then each query's partials merged by (distance, id)."""
    q, p = probes.shape
    L = codebooks.shape[2]
    plan = t_scan._pq_items(probes, indices, k, rows, group)
    slot_off = plan["slot_off"]
    partial = {}
    for lid, start, cnt, chunk, r0, nrows in _items(plan, rows, group):
        assert 0 < cnt <= group and 0 < nrows <= rows
        ids = indices[lid, r0:r0 + nrows]
        for e in range(start, start + cnt):
            r, slot = int(plan["pair_q"][e]), int(plan["pair_slot"][e])
            assert int(probes[r, slot]) == lid
            qsub = (qres[r] if ip_metric else qres[r, slot]).reshape(1, -1, L)
            cb = codebooks[lid][None] if per_cluster else codebooks
            cbn = None if ip_metric else (
                cb_norms[lid][None] if per_cluster else cb_norms)
            lut, scale = t_scan.quantize_lut(
                t_scan.probe_lut(qsub, cb, cbn, ip_metric, per_cluster),
                lut_dtype)
            codes_r = t_scan.unpack_codes(codes[lid, r0:r0 + nrows], packed)
            S = lut.shape[1]
            terms = lut[0][torch.arange(S)[None, :],
                           codes_r[:, :S].to(torch.int64)]
            d = pq_tests._kernel_row_sum(terms, S, pass_bits)
            d = t_scan.scale_and_base(d, None if scale is None else scale[0],
                                        base[r, slot] if ip_metric else None)
            if ip_metric:
                d = -d
            ok = ids >= 0
            if fw is not None:
                words = fw if fw.dim() == 1 else fw[r]
                ok = ok & (((words[ids.clamp(min=0) // 32]
                             >> (ids.clamp(min=0) % 32)) & 1) == 1)
            ok = ok & (d < float("inf"))
            dd, ii = d[ok], ids[ok]
            order = np.lexsort((ii.numpy(), dd.numpy()))[:k]
            at = int(slot_off[r * p + slot]) + chunk
            assert at not in partial, "a partial written twice"
            partial[at] = (dd[order], ii[order])
    out_d = torch.full((q, k), float("inf"))
    out_i = torch.full((q, k), -1, dtype=torch.int32)
    for r in range(q):
        lo, hi = int(slot_off[r * p]), int(slot_off[(r + 1) * p])
        assert all(at in partial for at in range(lo, hi)), "unwritten"
        if lo == hi:
            continue
        d = torch.cat([partial[at][0] for at in range(lo, hi)])
        ids = torch.cat([partial[at][1] for at in range(lo, hi)])
        order = np.lexsort((ids.numpy(), d.numpy()))[:k]
        out_d[r, :len(order)] = d[order]
        out_i[r, :len(order)] = ids[order]
    assert len(partial) == int(slot_off[-1])
    if ip_metric:
        out_d = -out_d
    return out_d, out_i


def _case(seed, *, ip_metric=False, per_cluster=False, bits=8, k=10,
          q=12, p=5, n_lists=6, m=300, live_rows=260, pq_dim=16, L=2,
          filt=None, hot=None, ragged=True):
    """Random scan inputs: ``n_lists`` lists of ``m`` slots (ids -1 past
    ``live_rows`` and every 37th), ``q`` queries x ``p`` probe slots drawn
    with repeats (made the sentinel) and ragged sentinel tails; with
    ``hot``, every query probes list ``hot`` first."""
    rng = np.random.default_rng(seed)
    book = 1 << bits
    codebooks = torch.from_numpy(rng.standard_normal(
        (n_lists if per_cluster else pq_dim, book, L)).astype(np.float32))
    raw = torch.from_numpy(rng.integers(0, book, (n_lists, m, pq_dim)).astype(
        np.uint8))
    packed = bits == 4 and pq_dim % 2 == 0
    codes = t_pq._pack_nibbles(raw) if packed else raw
    ids = rng.permutation(n_lists * m).reshape(n_lists, m).astype(np.int32)
    ids[:, live_rows:] = -1
    ids[:, ::37] = -1
    probes = rng.integers(0, n_lists, (q, p)).astype(np.int32)
    if hot is not None:
        probes[:, 0] = hot
    if ragged:
        probes[::3, p // 2 + 1:] = n_lists
    probes = t_scan.dedup_slots(torch.from_numpy(probes), n_lists)
    qres = torch.from_numpy(rng.standard_normal(
        (q, pq_dim * L) if ip_metric else (q, p, pq_dim * L)).astype(
            np.float32))
    base = torch.from_numpy(rng.standard_normal((q, p)).astype(np.float32))
    n_words = -(-n_lists * m // 32)
    fw = {None: None,
          "shared": rng.integers(-2**31, 2**31, n_words),
          "per_query": rng.integers(-2**31, 2**31, (q, n_words))}[filt]
    args = (qres, base if ip_metric else None, codebooks,
            None if ip_metric else t_scan.codebook_norms(codebooks), codes,
            torch.from_numpy(ids), probes,
            None if fw is None else torch.from_numpy(fw.astype(np.int32)))
    kw = dict(k=k, ip_metric=ip_metric, per_cluster=per_cluster,
              lut_dtype=torch.float32, packed=packed)
    return args, kw


# (label, case kwargs, lut, rows, group, pass_bits)
ITEM_CASES = [
    ("many-probers", dict(q=40, hot=2), "f32", 64, 4, 0),
    ("long-lists", dict(m=700, live_rows=650), "f32", 128, 4, 1),
    ("batch-1", dict(q=1, p=4), "bf16", 64, 16, 0),
    ("k258-4bit", dict(k=258, bits=4, pq_dim=64, m=400, live_rows=380,
                       hot=1), "f32", 128, 4, 2),
    ("8bit-k258", dict(k=258, q=20), "e4m3", 256, 2, 1),
    ("4bit-per-cluster", dict(bits=4, per_cluster=True, q=30, hot=0),
     "e5m2", 64, 8, 0),
    ("8bit-per-cluster-ip", dict(per_cluster=True, ip_metric=True,
                                 filt="shared"), "f32", 64, 4, 1),
    ("ip-per-query", dict(ip_metric=True, filt="per_query", q=25, hot=3),
     "bf16", 128, 8, 0),
    ("shared-filter-l3", dict(filt="shared", L=3, pq_dim=6), "e4m3", 64, 2,
     0),
    ("sentinels-odd-pq", dict(pq_dim=9, q=16, p=6), "f32", 32, 16, 0),
    ("main-shape", dict(q=40, pq_dim=64, m=1100, live_rows=1050, hot=4),
     "f32", 512, 16, 3),
    ("wide-items", dict(q=24, m=1500, live_rows=1400, hot=5), "f32", 1024,
     8, 1),
]


@pytest.mark.parametrize("case", ITEM_CASES, ids=lambda c: c[0])
def test_item_model_equals_plain(case):
    _, case_kw, lut, rows, group, pass_bits = case
    args, kw = _case(len(ITEM_CASES) + rows + group, **case_kw)
    kw["lut_dtype"] = pq_tests._LUTS[lut][1]
    want = t_scan.ivf_pq_scan(*args, **kw, engine="torch")
    got = _emulate_items(*args, **kw, rows=rows, group=group,
                         pass_bits=pass_bits)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("case", ITEM_CASES, ids=lambda c: c[0])
def test_plan_scores_each_live_row_of_each_pair_once(case):
    """Every live row of every real (query, slot) pair lies in exactly one
    item that holds the pair; sentinel and repeated slots get no item and
    no partial list; the partials are sized from the shapes alone."""
    _, case_kw, _, rows, group, _ = case
    args, kw = _case(rows + group, **case_kw)
    indices, probes = args[5], args[6]
    q, p = probes.shape
    n_lists, m = indices.shape
    plan = t_scan._pq_items(probes, indices, kw["k"], rows, group)
    seen = {}
    for lid, start, cnt, chunk, r0, nrows in _items(plan, rows, group):
        for e in range(start, start + cnt):
            r, slot = int(plan["pair_q"][e]), int(plan["pair_slot"][e])
            for row in range(r0, r0 + nrows):
                key = (r, slot, row)
                assert key not in seen
                seen[key] = lid
    slot_off = plan["slot_off"]
    for r in range(q):
        for slot in range(p):
            lid = int(probes[r, slot])
            n_part = int(slot_off[r * p + slot + 1] - slot_off[r * p + slot])
            if lid >= n_lists:
                assert n_part == 0
                assert not any(key[:2] == (r, slot) for key in seen)
                continue
            alive = np.nonzero(indices[lid].numpy() >= 0)[0]
            last = int(alive[-1]) + 1 if alive.size else 0
            assert n_part == -(-last // rows)
            for row in range(last):
                assert seen.pop((r, slot, row)) == lid
    assert not seen
    assert plan["pd"].numel() >= int(slot_off[-1]) * kw["k"]
    assert plan["pd"].numel() == q * p * -(-m // rows) * kw["k"]


def test_plan_puts_more_probers_than_a_group_in_several_items():
    args, kw = _case(3, q=40, hot=2)
    plan = t_scan._pq_items(args[6], args[5], 10, 64, 4)
    items = _items(plan, 64, 4)
    hot = [it for it in items if it[0] == 2]
    assert max(it[2] for it in hot) == 4
    assert len({it[1] for it in hot}) >= 10          # >= 40 / 4 groups
    assert len({it[3] for it in hot}) == -(-int(plan["live"][2]) // 64)


@pytest.mark.parametrize("metric,kind,bits,lut,filt", [
    ("L2Expanded", 0, 8, "f32", None),
    ("InnerProduct", 1, 4, "e4m3", "per_query"),
    ("L2Expanded", 1, 4, "bf16", "shared"),
    ("InnerProduct", 0, 8, "e4m3", None),
])
def test_item_model_search_equals_the_jax_xla_engine(monkeypatch, metric,
                                                     kind, bits, lut, filt):
    """The port's search body with the item model as its scan, on the
    integer-valued JAX index carried across, against the JAX ``xla``
    engine: ids equal, distances to float32 rounding."""
    ji, ti = pq_tests._pair(DistanceType[metric], t_pq.CodebookKind(kind),
                            bits)
    q = pq_tests._int_data(7, 20)
    fw = pq_tests._filter(filt, 20)
    jl, tl = pq_tests._LUTS[lut]

    def model(*args, engine, score=None, **kw):
        del engine, score
        return _emulate_items(*args, **kw, rows=64, group=4)

    monkeypatch.setattr(t_pq, "ivf_pq_scan", model)
    td, tix = t_pq.search(pq_tests.CPU, t_pq.IvfPqSearchParams(
        n_probes=3, scan_engine="torch", lut_dtype=tl), ti, q, 10,
        sample_filter=None if fw is None else torch.from_numpy(fw))
    jd, jix = j_pq.search(None, j_pq.IvfPqSearchParams(
        n_probes=3, scan_engine="xla", lut_dtype=jl), ji, q, 10,
        sample_filter=None if fw is None else jnp.asarray(fw))
    np.testing.assert_array_equal(np.asarray(jix), tix.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-6)
    assert (tix >= 0).sum() > 100
