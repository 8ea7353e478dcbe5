"""The port's IVF-PQ against the JAX package's: codes from ``extend``
(repack, incremental scatter, nibble packing), searches by the ``rank``
engine against the JAX ``rank`` engine and the ``torch`` engine against
the JAX ``xla`` engine over metric x codebook kind x pq_bits x
lut_dtype x score_mode x filter, the v4 file both ways, build quality,
and a CPU model of the CUDA kernel's sums and of its per-pair partial
lists (its list-major work items: ``test_torch_ivf_pq_items.py``).

Exactness: the carried-across indexes have integer centers and
codebooks, an identity rotation and integer data and queries, so every
residual, LUT entry and sum is an exact integer in both packages (fp8
tables are scaled by the same product by ``1 / fmax`` and divided by it
correctly rounded): ids and
codes must be equal and distances equal to float32 rounding (rtol 1e-6).
Builds draw from different generators, so a port build is held to the
JAX build's recall, within 0.02.
"""

from __future__ import annotations

import dataclasses
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_pq as j_pq
from raft_tpu_torch import Resources
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_pq as t_pq
from raft_tpu_torch.ops import ivf_pq_scan as t_scan
from raft_tpu_torch.ops.bq_scan import tree_sum

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N_LISTS, DIM, PQ_DIM = 8, 16, 8
_LUTS = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16),
         "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}
_FIELDS = ("centers", "rotation", "codebooks", "codes", "indices",
           "list_sizes")


def _int_data(seed, n, dim=DIM, lo=-8, hi=9):
    return np.random.default_rng(seed).integers(lo, hi, (n, dim)).astype(
        np.float32)


def _empty_jax_index(metric, kind, bits, seed=0):
    """A JAX index with integer centers and codebooks, identity rotation,
    no rows."""
    rng = np.random.default_rng(seed)
    book = 1 << bits
    cb_rows = N_LISTS if kind == j_pq.CodebookKind.PER_CLUSTER else PQ_DIM
    return j_pq.IvfPqIndex(
        centers=jnp.asarray(rng.integers(-6, 7, (N_LISTS, DIM)), jnp.float32),
        rotation=jnp.eye(DIM, dtype=jnp.float32),
        codebooks=jnp.asarray(rng.integers(-3, 4, (cb_rows, book,
                                                   DIM // PQ_DIM)),
                              jnp.float32),
        codes=jnp.zeros((N_LISTS, 0, PQ_DIM), jnp.uint8),
        indices=jnp.full((N_LISTS, 0), -1, jnp.int32),
        list_sizes=jnp.zeros((N_LISTS,), jnp.int32),
        metric=metric, codebook_kind=kind, pq_bits=bits)


def _to_port(ji):
    return t_pq.from_numpy(*(np.asarray(getattr(ji, f)) for f in _FIELDS),
                           metric=int(ji.metric),
                           codebook_kind=int(ji.codebook_kind),
                           pq_bits=ji.pq_bits, packed=ji.packed, res=CPU)


def _assert_same_index(ji, ti):
    assert ji.packed == ti.packed
    for f in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ji, f)),
                                      getattr(ti, f).numpy(), err_msg=f)


_JAX_INDEXES = {}


def _pair(metric, kind, bits):
    """(JAX index, port index) with 600 integer rows added to each."""
    key = (int(metric), int(kind), bits)
    if key not in _JAX_INDEXES:
        ji = j_pq.extend(None, _empty_jax_index(JD(int(metric)),
                                                j_pq.CodebookKind(int(kind)),
                                                bits), _int_data(1, 600))
        _JAX_INDEXES[key] = ji
    ji = _JAX_INDEXES[key]
    return ji, _to_port(ji)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kind", list(t_pq.CodebookKind), ids=str)
def test_extend_codes_equal_the_reference(kind, bits):
    ji = _empty_jax_index(JD.L2Expanded, j_pq.CodebookKind(int(kind)), bits)
    ti = _to_port(ji)
    # repack (empty), incremental scatter (fits), repack (overflows)
    for seed, n in ((1, 600), (2, 5), (3, 400)):
        x = _int_data(seed, n)
        ids = np.arange(10_000 * seed, 10_000 * seed + n, dtype=np.int32)
        before = ti.max_list_size
        ji = j_pq.extend(None, ji, x, ids)
        ti = t_pq.extend(CPU, ti, x, ids)
        _assert_same_index(ji, ti)
        if seed == 2:
            assert ti.max_list_size == before      # the incremental path
    assert ti.packed == (bits == 4)


def test_incremental_extend_donates_in_place():
    ji, ti = _pair(DistanceType.L2Expanded, t_pq.CodebookKind.PER_SUBSPACE, 4)
    codes = ti.codes
    out = t_pq.extend(CPU, ti, _int_data(9, 3), donate=True)
    assert out.codes is codes and out.size == ti.size + 3
    kept = t_pq.extend(CPU, _pair(DistanceType.L2Expanded,
                                  t_pq.CodebookKind.PER_SUBSPACE, 4)[1],
                       _int_data(9, 3))
    assert torch.equal(kept.codes, out.codes)


def test_nibble_packing_round_trips():
    codes = torch.from_numpy(np.random.default_rng(0).integers(
        0, 16, (5, 7, 12)).astype(np.uint8))
    packed = t_pq._pack_nibbles(codes)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(j_pq._pack_nibbles(jnp.asarray(codes))))
    assert torch.equal(t_pq._unpack_nibbles(packed), codes)


# (metric, codebook kind, pq_bits, lut, score_mode, filter)
SEARCH_CASES = [
    ("L2Expanded", 0, 8, "f32", "gather", None),
    ("L2Expanded", 0, 4, "f32", "gather", "shared"),
    ("L2SqrtExpanded", 1, 8, "bf16", "gather", None),
    ("InnerProduct", 0, 8, "f32", "auto", "per_query"),
    ("InnerProduct", 1, 4, "e4m3", "gather", None),
    ("L2Expanded", 1, 4, "e5m2", "gather", None),
    ("L2Expanded", 0, 4, "f32", "select", None),
    ("InnerProduct", 0, 4, "bf16", "onehot", "shared"),
    ("L2Expanded", 0, 8, "e4m3", "onehot", None),
    ("L2SqrtExpanded", 0, 4, "e5m2", "gather", "per_query"),
    ("InnerProduct", 1, 8, "bf16", "gather", "shared"),
    ("L2Expanded", 1, 4, "f32", "select", None),
    # the fp8 scale's rounding: these integer IP tables land on e5m2 ties
    ("InnerProduct", 0, 4, "e5m2", "gather", None),
    ("InnerProduct", 0, 8, "e5m2", "gather", None),
    ("InnerProduct", 1, 4, "e5m2", "gather", None),
    ("InnerProduct", 1, 8, "e5m2", "gather", "shared"),
]


def _filter(kind, q, seed=4):
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    n_words = -(-700 // 32)
    shape = (n_words,) if kind == "shared" else (q, n_words)
    return rng.integers(-2**31, 2**31, shape).astype(np.int32)


@pytest.mark.parametrize("case", SEARCH_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_search_engines_equal_the_reference(case):
    metric_name, kind, bits, lut, score_mode, filt = case
    metric = DistanceType[metric_name]
    ji, ti = _pair(metric, t_pq.CodebookKind(kind), bits)
    q = _int_data(5, 20)
    fw = _filter(filt, 20)
    jl, tl = _LUTS[lut]
    for t_engine, j_engine in (("rank", "rank"), ("torch", "xla")):
        jd, jix = j_pq.search(None, j_pq.IvfPqSearchParams(
            n_probes=3, scan_engine=j_engine, lut_dtype=jl,
            score_mode=score_mode), ji, q, 10,
            sample_filter=None if fw is None else jnp.asarray(fw))
        td, tix = t_pq.search(CPU, t_pq.IvfPqSearchParams(
            n_probes=3, scan_engine=t_engine, lut_dtype=tl,
            score_mode=score_mode), ti, q, 10,
            sample_filter=None if fw is None else torch.from_numpy(fw))
        np.testing.assert_array_equal(np.asarray(jix), tix.numpy(),
                                      err_msg=t_engine)
        np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-6,
                                   err_msg=t_engine)
        assert (tix >= 0).sum() > 100


def test_search_tiles_and_probe_plane():
    ji, ti = _pair(DistanceType.L2Expanded, t_pq.CodebookKind.PER_SUBSPACE, 8)
    q = _int_data(6, 37)
    sp = t_pq.IvfPqSearchParams(n_probes=4, scan_engine="torch")
    whole = t_pq.search(CPU, sp, ti, q, 10)
    tiled = t_pq.search(CPU, sp, ti, q, 10, query_tile=16)
    assert torch.equal(whole[1], tiled[1]) and torch.equal(whole[0], tiled[0])
    fn, arrays, static = t_pq.serving_plan(sp, ti, 10)
    plane = torch.zeros(N_LISTS, dtype=torch.int32)
    d, i, counts = fn(torch.from_numpy(q), *arrays, None, plane, 30, **static)
    assert torch.equal(i[:30], whole[1][:30]) and int(counts.sum()) == 120
    jd, jix = j_pq.search(None, j_pq.IvfPqSearchParams(
        n_probes=4, scan_engine="xla"), ji, q, 10)
    np.testing.assert_array_equal(np.asarray(jix), whole[1].numpy())


def test_files_cross_both_ways():
    for bits, kind in ((4, 0), (8, 1)):
        ji, ti = _pair(DistanceType.InnerProduct, t_pq.CodebookKind(kind),
                       bits)
        jbuf, tbuf = io.BytesIO(), io.BytesIO()
        j_pq.save(ji, jbuf)
        t_pq.save(t_pq.load(CPU, io.BytesIO(jbuf.getvalue())), tbuf)
        assert tbuf.getvalue() == jbuf.getvalue()
        back = j_pq.load(None, io.BytesIO(tbuf.getvalue()))
        _assert_same_index(back, ti)
        assert back.packed == ti.packed and back.pq_bits == bits


def test_build_reproducible_and_quality_within_reference():
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((64, 32)) * 3
    x = (centers[rng.integers(0, 64, 4096)]
         + rng.standard_normal((4096, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 64, 300)]
         + rng.standard_normal((300, 32))).astype(np.float32)
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :10]
    params = dict(n_lists=32, pq_dim=16, pq_bits=8)
    ji = j_pq.build(None, j_pq.IvfPqIndexParams(**params), x)
    ti = t_pq.build(CPU, t_pq.IvfPqIndexParams(**params), x)
    again = t_pq.build(Resources(device="cpu"), t_pq.IvfPqIndexParams(
        **params), x)
    for f in _FIELDS:
        assert torch.equal(getattr(ti, f), getattr(again, f)), f

    def recall(ids):
        ids = np.asarray(ids)
        return np.mean([len(set(a) & set(b)) / 10.0
                        for a, b in zip(ids, truth)])

    _, jix = j_pq.search(None, j_pq.IvfPqSearchParams(n_probes=8), ji, q, 10)
    _, tix = t_pq.search(CPU, t_pq.IvfPqSearchParams(n_probes=8), ti, q, 10)
    rj, rt = recall(jix), recall(tix.numpy())
    assert rj > 0.5
    assert rt >= rj - 0.02, (rt, rj)


def test_random_rotation_is_orthogonal_and_builds():
    gen = torch.Generator().manual_seed(3)
    r = t_pq.make_rotation_matrix(gen, 24, 20, False)
    assert r.shape == (24, 20)
    torch.testing.assert_close(r.T @ r, torch.eye(20), atol=1e-5, rtol=0)
    assert torch.equal(t_pq.make_rotation_matrix(gen, 16, 16, False),
                       torch.eye(16))
    x = _int_data(3, 500, dim=20).astype(np.float32)
    idx = t_pq.build(CPU, t_pq.IvfPqIndexParams(n_lists=4, pq_dim=8), x)
    assert (idx.dim_ext, idx.pq_len, idx.size) == (24, 3, 500)
    assert not torch.equal(idx.rotation[:20], torch.eye(20))


def test_engine_resolution_and_errors():
    _, ti = _pair(DistanceType.L2Expanded, t_pq.CodebookKind.PER_SUBSPACE, 8)
    assert t_pq.resolve_scan_engine("auto", ti, 10) == "rank"
    assert t_pq.resolve_scan_engine("torch", ti, 10) == "torch"
    assert t_pq.resolve_scan_engine("auto") == "rank"
    with pytest.raises(RaftError, match="CUDA device"):
        t_pq.resolve_scan_engine("cuda", ti, 10)
    assert t_pq.resolve_score_mode("auto") == "gather"
    # an index on the card: auto is the kernel at any table size, and
    # only k past 512 goes to the plain engine
    on_card = types.SimpleNamespace(codes=types.SimpleNamespace(
        device=torch.device("cuda")))
    for engine in ("auto", "cuda"):
        assert t_pq.resolve_scan_engine(engine, on_card, 512) == "cuda"
        assert t_pq.resolve_scan_engine(engine, on_card, 513) == "torch"
    with pytest.raises(RaftError, match="gather"):
        t_pq.resolve_scan_engine("cuda", on_card, 10, "onehot")
    with pytest.raises(RaftError, match="scan_engine"):
        t_pq.search(CPU, t_pq.IvfPqSearchParams(scan_engine="xla"), ti,
                    _int_data(0, 2), 5)
    with pytest.raises(RaftError, match="lut_dtype"):
        t_pq.search(CPU, t_pq.IvfPqSearchParams(lut_dtype=torch.float16),
                    ti, _int_data(0, 2), 5)
    # tiered codes: the rank-major engine has no per-list fetch step
    maps = torch.arange(N_LISTS, dtype=torch.int32)
    with pytest.raises(RaftError, match="list-major engine"):
        t_pq._search_impl_fn(torch.zeros(2, DIM), *t_pq.serving_plan(
            t_pq.IvfPqSearchParams(), ti, 5)[1], None,
            cold_codes=ti.codes[:0], hot_slot_map=maps,
            cold_slot_map=-1 - 0 * maps, n_probes=2, k=5, metric=ti.metric,
            codebook_kind=ti.codebook_kind)
    # build_streaming is ported: it refuses what the JAX one refuses
    with pytest.raises(RaftError, match="PER_SUBSPACE"):
        t_pq.build_streaming(CPU, t_pq.IvfPqIndexParams(
            codebook_kind=t_pq.CodebookKind.PER_CLUSTER), None)
    with pytest.raises(RaftError, match="pq_bits"):
        t_pq.build(CPU, t_pq.IvfPqIndexParams(pq_bits=3), _int_data(0, 64))


# ---------------------------------------------------------------------------
# a CPU model of csrc/ivf_pq_scan.cu
# ---------------------------------------------------------------------------


def _brev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _kernel_row_sum(terms: torch.Tensor, pq_dim: int,
                    pass_bits: int = 0) -> torch.Tensor:
    """The kernel's Σ_s: groups of eight subspaces s0 + brev3(u)·G (G =
    W/8, s0 the bit-reversed group index), each summed as ((0+1)+(2+3))+
    ((4+5)+(6+7)), the groups combined by a binary-counter stack. With
    ``pass_bits`` b the table is built in 2^b parts (csrc
    ``build_part``/``score_group``): part c holds the subspaces s with
    s mod 2^b = brev_b(c) at slot s >> b, and scores the groups
    c·G/2^b .. (c+1)·G/2^b - 1 with the stack carried over."""
    W = t_scan.tree_width(pq_dim)
    G, L = W // 8, (W // 8).bit_length() - 1
    passes = 1 << pass_bits
    brev3 = (0, 4, 2, 6, 1, 5, 3, 7)
    zero = torch.zeros_like(terms[..., 0])
    stack = {}
    total = None
    for c in range(passes):
        part = list(range(_brev(c, pass_bits), pq_dim, passes))
        table = terms[..., part]                    # slot i: s = c' + 2^b i
        for g in range(c * G // passes, (c + 1) * G // passes):
            s0 = _brev(g, L)
            v = []
            for s in (s0 + b * G for b in brev3):
                if s >= pq_dim:
                    v.append(zero)
                    continue
                assert s % passes == part[0] % passes   # in this part
                v.append(table[..., s >> pass_bits])
            gs = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5])
                                                    + (v[6] + v[7]))
            t, lvl = g, 0
            while t & 1:
                gs = stack[lvl] + gs
                t >>= 1
                lvl += 1
            stack[lvl] = gs
            total = gs
    return total


@pytest.mark.parametrize("pq_dim,pass_bits", [(240, 1), (240, 2), (196, 3),
                                             (100, 2), (512, 3), (9, 1)])
def test_kernel_table_parts_keep_the_sum_order(pq_dim, pass_bits):
    """Scoring a table built in parts, part after part with one carried
    stack, is tree_sum's sum bit for bit."""
    x = torch.from_numpy(np.random.default_rng(pq_dim).standard_normal(
        (300, pq_dim)).astype(np.float32))
    W = t_scan.tree_width(pq_dim)
    assert (1 << pass_bits) <= W // 8
    want = tree_sum(torch.nn.functional.pad(x, (0, W - pq_dim)))
    assert torch.equal(_kernel_row_sum(x, pq_dim, pass_bits), want)


@pytest.mark.parametrize("pq_dim", [1, 5, 8, 12, 64, 100])
def test_kernel_group_sum_equals_tree_sum(pq_dim):
    x = torch.from_numpy(np.random.default_rng(pq_dim).standard_normal(
        (500, pq_dim)).astype(np.float32))
    W = t_scan.tree_width(pq_dim)
    want = tree_sum(torch.nn.functional.pad(x, (0, W - pq_dim)))
    assert torch.equal(_kernel_row_sum(x, pq_dim), want)


def _emulate_blocks(qres, base, codebooks, cb_norms, codes, indices, probes,
                    fw, *, k, ip_metric, per_cluster, lut_dtype, packed):
    """One (query, probe slot) pair at a time: the pair's LUT, the rows'
    scores by :func:`_kernel_row_sum`, a partial top-k by (distance, id);
    then each query's partials merged by (distance, id)."""
    q, p = probes.shape
    n_lists = indices.shape[0]
    L = codebooks.shape[2]
    out_d = torch.full((q, k), float("inf"))
    out_i = torch.full((q, k), -1, dtype=torch.int32)
    for r in range(q):
        parts = []
        for slot in range(p):
            lid = int(probes[r, slot])
            if lid >= n_lists:
                continue
            qsub = (qres[r] if ip_metric else qres[r, slot]).reshape(1, -1, L)
            cb = codebooks[lid][None] if per_cluster else codebooks
            cbn = None if ip_metric else (
                cb_norms[lid][None] if per_cluster else cb_norms)
            lut, scale = t_scan.quantize_lut(
                t_scan.probe_lut(qsub, cb, cbn, ip_metric, per_cluster),
                lut_dtype)
            rows = t_scan.unpack_codes(codes[lid], packed).to(torch.int64)
            S = rows.shape[1]
            terms = lut[0][torch.arange(S)[None, :], rows]      # (m, S)
            d = _kernel_row_sum(terms, S)
            d = t_scan.scale_and_base(d, None if scale is None else scale[0],
                                        base[r, slot] if ip_metric else None)
            if ip_metric:
                d = -d
            ids = indices[lid]
            ok = ids >= 0
            if fw is not None:
                words = fw if fw.dim() == 1 else fw[r]
                ok = ok & (((words[ids.clamp(min=0) // 32]
                             >> (ids.clamp(min=0) % 32)) & 1) == 1)
            d, ids = d[ok], ids[ok]
            order = np.lexsort((ids.numpy(), d.numpy()))[:k]
            parts.append((d[order], ids[order]))
        if not parts:
            continue
        d = torch.cat([a for a, _ in parts])
        ids = torch.cat([b for _, b in parts])
        order = np.lexsort((ids.numpy(), d.numpy()))[:k]
        n = len(order)
        out_d[r, :n] = d[order]
        out_i[r, :n] = ids[order]
    if ip_metric:
        out_d = -out_d
    return out_d, out_i


@pytest.mark.parametrize("case", range(6))
def test_kernel_block_model_equals_list_major_twin(case):
    rng = np.random.default_rng(case)
    ip_metric, per_cluster = bool(case & 1), bool(case & 2)
    bits = 4 if case % 3 else 8
    lut_dtype = (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
                 torch.float8_e5m2, torch.float32, torch.bfloat16)[case]
    n_lists, m, q, p, pq_dim, L = 6, 90, 7, 4, (12, 6, 16)[case % 3], 2
    book = 1 << bits
    codebooks = torch.from_numpy(rng.standard_normal(
        (n_lists if per_cluster else pq_dim, book, L)).astype(np.float32))
    raw = torch.from_numpy(rng.integers(0, book, (n_lists, m, pq_dim)).astype(
        np.uint8))
    packed = bits == 4 and pq_dim % 2 == 0
    codes = t_pq._pack_nibbles(raw) if packed else raw
    ids = rng.permutation(n_lists * m).reshape(n_lists, m).astype(np.int32)
    ids[:, 70:] = -1
    indices = torch.from_numpy(ids)
    probes = torch.from_numpy(rng.integers(0, n_lists, (q, p)).astype(
        np.int32))
    probes[::2, 3] = n_lists
    probes = t_scan.dedup_slots(probes, n_lists)      # a list once a row
    qres = torch.from_numpy(rng.standard_normal(
        (q, pq_dim * L) if ip_metric else (q, p, pq_dim * L)).astype(
            np.float32))
    base = torch.from_numpy(rng.standard_normal((q, p)).astype(np.float32))
    fw = None if case < 3 else torch.from_numpy(rng.integers(
        -2**31, 2**31, (q, -(-n_lists * m // 32))).astype(np.int32))
    cb_norms = t_scan.codebook_norms(codebooks)
    k = 9 + case
    args = (qres, base if ip_metric else None, codebooks,
            None if ip_metric else cb_norms, codes, indices, probes, fw)
    kw = dict(k=k, ip_metric=ip_metric, per_cluster=per_cluster,
              lut_dtype=lut_dtype, packed=packed)
    want = t_scan.ivf_pq_scan(*args, **kw, engine="torch")
    got = _emulate_blocks(*args, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_dedup_slots_keeps_first_occurrence():
    pr = torch.tensor([[3, 1, 3, 9, -1, 1]], dtype=torch.int32)
    assert t_scan.dedup_slots(pr, 5).tolist() == [[3, 1, 5, 5, 5, 5]]


def test_index_properties_and_helpers():
    _, ti = _pair(DistanceType.L2Expanded, t_pq.CodebookKind.PER_SUBSPACE, 4)
    assert (ti.n_lists, ti.dim, ti.dim_ext, ti.pq_dim, ti.pq_len,
            ti.pq_book_size, ti.size) == (N_LISTS, DIM, DIM, PQ_DIM, 2, 16,
                                          600)
    assert ti.packed and ti.codes.shape[2] == PQ_DIM // 2
    assert t_pq._auto_pq_dim(128) == 32 and t_pq._auto_pq_dim(20) == 5
    assert dataclasses.replace(t_pq.IvfPqSearchParams(),
                               n_probes=7).n_probes == 7
