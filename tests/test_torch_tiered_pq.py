"""Tiered IVF-PQ in the port against the JAX package, on the CPU.

The JAX package's index (integer centers and codebooks, identity
rotation, integer rows added by ``extend``) crosses into the port with
``tiered.from_numpy_pq`` and a given hot/cold split. The JAX side is
driven through its tiered *body* (``_tiered_pq_search_fn``, jitted) on
the same planes split with numpy, never through its tiered containers,
whose host placement does not run under jax 0.9 on the CPU; and through
its all-device ``ivf_pq.search`` (the ``xla`` engine). Every residual,
LUT entry and sum is an exact integer in both packages: ids must be
equal and distances equal to float32 rounding (rtol 1e-6), before and
after placement swaps. The port's tiered search also equals its own
all-device search bit for bit.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_pq as j_pq
from raft_tpu.neighbors import tiered as j_tiered
from raft_tpu_torch import Resources
from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.neighbors import ivf_pq, tiered

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N_LISTS, DIM, PQ_DIM = 8, 16, 8
_FIELDS = ("centers", "rotation", "codebooks", "codes", "indices",
           "list_sizes")

SPLITS = {
    "all-hot": (list(range(N_LISTS)), []),
    "half-cold": ([0, 1, 2, 3], [4, 5, 6, 7]),
    "alternate": ([0, 2, 4, 6], [1, 3, 5, 7]),
    "all-cold": ([], list(range(N_LISTS))),
}

# (metric, codebook kind, pq_bits, filter)
CASES = [
    ("L2Expanded", 0, 8, None),
    ("L2Expanded", 1, 4, "shared"),
    ("InnerProduct", 0, 4, "per_query"),
    ("InnerProduct", 1, 8, None),
    ("L2SqrtExpanded", 0, 8, "shared"),
    ("L2Expanded", 0, 4, "per_query"),
]


def _int_data(seed, n, dim=DIM, lo=-8, hi=9):
    return np.random.default_rng(seed).integers(lo, hi, (n, dim)).astype(
        np.float32)


_JAX = {}


def _jax_index(metric: str, kind: int, bits: int):
    """A JAX index with integer centers and codebooks, identity rotation
    and 700 integer rows."""
    key = (metric, kind, bits)
    if key not in _JAX:
        rng = np.random.default_rng(0)
        jkind = j_pq.CodebookKind(kind)
        cb_rows = N_LISTS if jkind == j_pq.CodebookKind.PER_CLUSTER \
            else PQ_DIM
        empty = j_pq.IvfPqIndex(
            centers=jnp.asarray(rng.integers(-6, 7, (N_LISTS, DIM)),
                                jnp.float32),
            rotation=jnp.eye(DIM, dtype=jnp.float32),
            codebooks=jnp.asarray(rng.integers(
                -3, 4, (cb_rows, 1 << bits, DIM // PQ_DIM)), jnp.float32),
            codes=jnp.zeros((N_LISTS, 0, PQ_DIM), jnp.uint8),
            indices=jnp.full((N_LISTS, 0), -1, jnp.int32),
            list_sizes=jnp.zeros((N_LISTS,), jnp.int32),
            metric=JD[metric], codebook_kind=jkind, pq_bits=bits)
        _JAX[key] = j_pq.extend(None, empty, _int_data(1, 700))
    return _JAX[key]


def _fields(ji) -> dict:
    out = {f: np.asarray(getattr(ji, f)) for f in _FIELDS}
    out.update(metric=int(ji.metric), codebook_kind=int(ji.codebook_kind),
               pq_bits=ji.pq_bits, packed=ji.packed)
    return out


def _filter(kind, q, seed=4):
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    n_words = -(-700 // 32)
    shape = (n_words,) if kind == "shared" else (q, n_words)
    return rng.integers(-2**31, 2**31, shape).astype(np.int32)


def _jax_planes(ji, hot_lists, cold_lists):
    """The JAX body's split planes: an empty tier gets one block that no
    slot map names (XLA cannot index a zero-length axis)."""
    codes = np.asarray(ji.codes)
    hot_lists = np.asarray(hot_lists, np.int64)
    cold_lists = np.asarray(cold_lists, np.int64)
    hot = codes[hot_lists] if len(hot_lists) else codes[:1]
    cold = codes[cold_lists] if len(cold_lists) else codes[:1]
    hmap, cmap = tiered._slot_maps(hot_lists.astype(np.int32),
                                   cold_lists.astype(np.int32), N_LISTS)
    return tuple(jnp.asarray(a) for a in (hot, cold, hmap, cmap))


def _jax_tiered(ji, hot_lists, cold_lists, q, fw, *, n_probes, k, lut,
                row_probes=None):
    hot, cold, hmap, cmap = _jax_planes(ji, hot_lists, cold_lists)
    args = (jnp.asarray(q), ji.centers, ji.rotation, ji.codebooks, hot,
            cold, hmap, cmap, ji.indices,
            None if fw is None else jnp.asarray(fw))
    kw = dict(n_probes=n_probes, k=k, metric=ji.metric,
              codebook_kind=ji.codebook_kind, lut_dtype=lut,
              score_mode="gather", packed=ji.packed, scan_engine="xla")
    if row_probes is None:
        return j_tiered._tiered_pq_search(*args, coarse_algo="exact", **kw)
    return j_tiered._tiered_pq_search_ragged_fn(
        args[0], jnp.asarray(row_probes), *args[1:], **kw)


def _same(got, jd, ji_):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji_))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jd), rtol=1e-6)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_search_pq_equals_the_jax_body_and_all_device_search(case, split):
    metric, kind, bits, filt = case
    ji = _jax_index(metric, kind, bits)
    hot_lists, cold_lists = SPLITS[split]
    flat = ivf_pq.from_numpy(**_fields(ji), res=CPU)
    t = tiered.from_numpy_pq(_fields(ji), hot_lists, cold_lists, res=CPU)
    assert (t.n_hot, t.n_cold) == (len(hot_lists), len(cold_lists))
    assert t.packed == (bits == 4) and not t.host_resident
    q = _int_data(5, 24)
    fw = _filter(filt, 24)
    sp = ivf_pq.IvfPqSearchParams(n_probes=3, scan_engine="torch")
    tfw = None if fw is None else torch.from_numpy(fw)
    jd, jix = j_pq.search(None, j_pq.IvfPqSearchParams(
        n_probes=3, scan_engine="xla"), ji, q, 10,
        sample_filter=None if fw is None else jnp.asarray(fw))
    for epoch in range(3):
        got = tiered.search_pq(CPU, sp, t, q, 10, sample_filter=tfw)
        want = ivf_pq.search(CPU, sp, flat, q, 10, sample_filter=tfw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        _same(got, jd, jix)
        bd, bi = _jax_tiered(ji, t.hot_lists, t.cold_lists, q, fw,
                             n_probes=3, k=10, lut=jnp.float32)
        _same(got, bd, bi)
        assert (got[1] >= 0).sum() > 100
        # a swap of a hot and a cold list, where both tiers have one
        if t.n_hot and t.n_cold:
            tiered.apply_plan(t, [int(t.cold_lists[epoch % t.n_cold])],
                              [int(t.hot_lists[-1 - epoch % t.n_hot])],
                              width=2)
            assert t.generation == epoch + 1


@pytest.mark.parametrize("lut", [(jnp.bfloat16, torch.bfloat16),
                                 (jnp.float8_e4m3fn, torch.float8_e4m3fn),
                                 (jnp.float8_e5m2, torch.float8_e5m2)],
                         ids=["bf16", "e4m3", "e5m2"])
def test_search_pq_lut_types_equal_the_jax_body(lut):
    ji = _jax_index("InnerProduct", 0, 8)
    jl, tl = lut
    hot_lists, cold_lists = SPLITS["alternate"]
    t = tiered.from_numpy_pq(_fields(ji), hot_lists, cold_lists, res=CPU)
    flat = ivf_pq.from_numpy(**_fields(ji), res=CPU)
    q = _int_data(6, 20)
    sp = ivf_pq.IvfPqSearchParams(n_probes=4, scan_engine="torch",
                                  lut_dtype=tl)
    got = tiered.search_pq(CPU, sp, t, q, 10)
    want = ivf_pq.search(CPU, sp, flat, q, 10)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    _same(got, *_jax_tiered(ji, hot_lists, cold_lists, q, None, n_probes=4,
                            k=10, lut=jl))


def test_ragged_body_equals_the_jax_ragged_body_and_solo_searches():
    ji = _jax_index("L2Expanded", 0, 8)
    hot_lists, cold_lists = SPLITS["half-cold"]
    t = tiered.from_numpy_pq(_fields(ji), hot_lists, cold_lists, res=CPU)
    q = _int_data(7, 16)
    budgets = np.array([1, 2, 3, 4, 4, 2, 0, 3] * 2, np.int32)
    fn, arrays, static = tiered.serving_plan_pq(
        ivf_pq.IvfPqSearchParams(n_probes=4, scan_engine="torch"), t, 10)
    del static["coarse_algo"]
    got = tiered._tiered_pq_search_ragged_fn(
        torch.from_numpy(q), torch.from_numpy(budgets), *arrays, None,
        **static)
    jd, jix = _jax_tiered(ji, hot_lists, cold_lists, q, None, n_probes=4,
                          k=10, lut=jnp.float32, row_probes=budgets)
    _same(got, jd, jix)
    for r, b in enumerate(budgets):
        if b == 0:
            assert (got[1][r] == -1).all()
            continue
        solo = tiered.search_pq(CPU, ivf_pq.IvfPqSearchParams(
            n_probes=int(b), scan_engine="torch"), t, q[r:r + 1], 10)
        assert torch.equal(got[1][r], solo[1][0])
        assert torch.equal(got[0][r], solo[0][0])


def test_executor_plans_equal_direct_searches():
    ji = _jax_index("L2Expanded", 1, 4)
    t = tiered.from_numpy_pq(_fields(ji), *SPLITS["alternate"], res=CPU)
    q = _int_data(8, 37)
    sp = ivf_pq.IvfPqSearchParams(n_probes=4)
    want = tiered.search_pq(CPU, sp, t, q, 10)
    ex = SearchExecutor(CPU, probe_accounting=True, ragged_tile=32)
    got = ex.search(t, q, 10, params=sp)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert ex.stats.compile_count == 1
    counts = ex.probe_frequencies()[ex.probe_label(t)]
    assert int(counts.sum()) == 37 * 4
    # an epoch keeps the plan entry: shapes and statics only in the key
    tiered.apply_plan(t, [1], [0], width=1, executor=ex)
    got = ex.search(t, q, 10, params=sp)
    assert torch.equal(got[1], want[1]) and ex.stats.compile_count == 1
    assert ex.ragged_key(t, 10, params=sp) is not None
    blocks = [q[:5], q[5:6], q[6:20]]
    ragged = ex.search_ragged(t, blocks, [10, 10, 10],
                              params_list=[sp] * 3)
    for (d, i), blk in zip(ragged, blocks):
        solo = tiered.search_pq(CPU, sp, t, blk, 10)
        assert torch.equal(i, solo[1]) and torch.equal(d, solo[0])
    assert ex.ragged_executables("tiered_ivf_pq") == 1


def test_rank_engine_and_bad_params_are_refused():
    ji = _jax_index("L2Expanded", 0, 8)
    t = tiered.from_numpy_pq(_fields(ji), *SPLITS["half-cold"], res=CPU)
    q = _int_data(9, 3)
    with pytest.raises(RaftError, match="per-list fetch step"):
        tiered.search_pq(CPU, ivf_pq.IvfPqSearchParams(scan_engine="rank"),
                         t, q, 5)
    with pytest.raises(RaftError, match="CUDA device"):
        tiered.search_pq(CPU, ivf_pq.IvfPqSearchParams(scan_engine="cuda"),
                         t, q, 5)
    with pytest.raises(RaftError, match="lut_dtype"):
        tiered.search_pq(CPU, ivf_pq.IvfPqSearchParams(
            lut_dtype=torch.float16), t, q, 5)
    # auto is the plain engine on the CPU, and k past the kernel's 512 too
    from raft_tpu_torch.ops.tier_scan import resolve_tier_pq_engine

    assert resolve_tier_pq_engine("auto", hot_codes=t.hot_codes) == "torch"
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    for engine in ("auto", "cuda"):
        assert resolve_tier_pq_engine(engine, hot_codes=on_card,
                                      k=512) == "cuda"
        assert resolve_tier_pq_engine(engine, hot_codes=on_card,
                                      k=513) == "torch"


def test_build_tiered_pq_prices_blocks_at_codes_bytes():
    ji = _jax_index("L2Expanded", 0, 8)
    flat = ivf_pq.from_numpy(**_fields(ji), res=CPU)
    t = tiered.build_tiered_pq(flat, hot_fraction=0.25)
    assert t.n_hot == 2 and t.n_cold == N_LISTS - 2
    assert t.block_bytes == flat.max_list_size * PQ_DIM
    assert t.pq_dim == PQ_DIM and t.pq_book_size == 256
    counts = np.arange(N_LISTS)[::-1].copy()
    t = tiered.build_tiered_pq(flat, hot_slots=3, probe_counts=counts)
    assert list(t.hot_lists) == [0, 1, 2]

    class Ledger:
        @staticmethod
        def headroom_bytes():
            return 5.5 * flat.max_list_size * PQ_DIM / 0.9

    t = tiered.build_tiered_pq(flat, ledger=Ledger())
    assert t.n_hot == 5
    layout = t.layout()
    assert layout["block_bytes"] == t.block_bytes
    assert sorted(layout["hot_lists"] + layout["cold_lists"]) == list(
        range(N_LISTS))


def test_stage_plan_stages_any_plane_by_its_row_bytes():
    """The ring's budget in bytes of a plane's rows: the PQ codes' 64 B
    rows or the flat family's float32 rows give the same plan as the
    same budget in rows, and the plan's staged bytes count its rows."""
    from raft_tpu_torch.ops.tier_scan import STAGE_TILE, tier_stage_plan

    rng = np.random.default_rng(2)
    cold_fetch = np.where(rng.random(40) < 0.5, np.arange(40), -1)
    rows = rng.integers(1, 700, 40)
    for row_bytes in (64, 32, 4 * 128):
        for cap_rows in (10**6, 1500, 300):
            want = tier_stage_plan(cold_fetch, rows, 700, cap_rows)
            got = tier_stage_plan(cold_fetch, rows, 700, cap_rows * row_bytes,
                                  row_bytes=row_bytes)
            for f in ("steps", "slots", "rows", "offsets", "wave_end"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert (got.ring_rows, got.reuse) == (want.ring_rows, want.reuse)
            assert got.staged_bytes == int(got.rows.sum()) * row_bytes
            assert (got.rows % STAGE_TILE == 0).all() or (got.rows == 700
                                                          ).any()
