"""raft_tpu_torch.comms against raft_tpu.comms: every collective and wire
run over R in {2, 4, 8} shard slots of the port and R virtual CPU
devices of the JAX package, on the same per-rank blocks.

Tolerances: integer payloads and every gather, permutation and
broadcast are exact. A float SUM over ranks is taken in rank order by
the port and in XLA's order by the JAX package: rtol 1e-6. The quantized
wires' int8 codes are exact (:func:`_quantize_blocks`, and the affine
probe codes recomputed from the gathered values); their dequantized
values differ by XLA's contraction of ``q * (s * c) + lo`` into a fused
multiply-add: rtol 1e-6 with an atol of 1e-6 of the block's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import raft_tpu.comms.comms as jc
import raft_tpu_torch.comms.comms as tc
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms.bootstrap import make_mesh as j_make_mesh
from raft_tpu_torch.comms import P, local_comms
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import RaftError

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

R_VALUES = [2, 4, 8]


def _jcomms(r):
    return JComms(j_make_mesh(devices=jax.devices()[:r]), "data")


def _tcomms(r):
    return local_comms(shape=(r,), device="cpu")


def _run_both(r, j_body, t_body, x):
    """Run one body over the row-sharded ``x`` in both packages; each
    rank's output blocks are concatenated along dim 0."""
    jc_ = _jcomms(r)
    jout = jc_.run(j_body, jax.device_put(jnp.asarray(x), jc_.row_sharded()),
                   in_specs=JP("data"), out_specs=JP("data"),
                   check_vma=False)
    tout = _tcomms(r).run(t_body, torch.as_tensor(x), in_specs=P("data"),
                          out_specs=P("data"))
    return np.asarray(jout), tout.numpy()


def _blocks(rng, r, rows, n, kind="f"):
    if kind == "i":
        return rng.integers(-50, 50, (r * rows, n)).astype(np.int32)
    return rng.standard_normal((r * rows, n)).astype(np.float32)


@pytest.mark.parametrize("r", R_VALUES)
class TestCollectives:
    @pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD"])
    @pytest.mark.parametrize("kind", ["i", "f"])
    def test_allreduce(self, rng_np, r, op, kind):
        x = _blocks(rng_np, r, 3, 5, kind)
        if op == "PROD":
            x = (np.sign(x) + (x == 0)).astype(x.dtype)     # +-1: exact
        j, t = _run_both(r, lambda v: jc.allreduce(v, jc.Op[op], "data"),
                         lambda v: tc.allreduce(v, tc.Op[op], "data"), x)
        if kind == "i" or op != "SUM":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("root", [0, 1])
    def test_bcast_and_reduce(self, rng_np, r, root):
        x = _blocks(rng_np, r, 2, 4, "i")
        j, t = _run_both(r, lambda v: jc.bcast(v, root, "data"),
                         lambda v: tc.bcast(v, root, "data"), x)
        np.testing.assert_array_equal(t, j)
        j, t = _run_both(r, lambda v: jc.reduce(v, root, jc.Op.SUM, "data"),
                         lambda v: tc.reduce(v, root, tc.Op.SUM, "data"), x)
        np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("tiled", [False, True])
    def test_allgather_and_gather(self, rng_np, r, tiled):
        x = _blocks(rng_np, r, 2, 3)
        j, t = _run_both(r, lambda v: jc.allgather(v, "data", tiled),
                         lambda v: tc.allgather(v, "data", tiled), x)
        np.testing.assert_array_equal(t, j)
        j, t = _run_both(r, lambda v: jc.gather(v, 0, "data", tiled),
                         lambda v: tc.gather(v, 0, "data", tiled), x)
        np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("wire", ["f32", "bf16"])
    def test_allgather_wire(self, rng_np, r, wire):
        x = _blocks(rng_np, r, 3, 7)
        j, t = _run_both(r, lambda v: jc.allgather_wire(v, "data", wire),
                         lambda v: tc.allgather_wire(v, "data", wire), x)
        np.testing.assert_array_equal(t, j)

    def test_alltoall_and_reducescatter(self, rng_np, r):
        x = _blocks(rng_np, r, 2 * r, 3, "i")
        j, t = _run_both(r, lambda v: jc.alltoall(v, "data"),
                         lambda v: tc.alltoall(v, "data"), x)
        np.testing.assert_array_equal(t, j)
        for op in ("SUM", "MAX"):
            j, t = _run_both(
                r, lambda v: jc.reducescatter(v, jc.Op[op], "data"),
                lambda v: tc.reducescatter(v, tc.Op[op], "data"), x)
            np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("offset", [1, 3])
    def test_send_recv_sendrecv(self, rng_np, r, offset):
        x = _blocks(rng_np, r, 2, 3)
        j, t = _run_both(r, lambda v: jc.device_send(v, offset, "data"),
                         lambda v: tc.device_send(v, offset, "data"), x)
        np.testing.assert_array_equal(t, j)
        j, t = _run_both(r, lambda v: jc.device_recv(v, offset, "data"),
                         lambda v: tc.device_recv(v, offset, "data"), x)
        np.testing.assert_array_equal(t, j)
        perm = [(0, r - 1), (r - 1, 0)]           # ranks between: zeros
        j, t = _run_both(r, lambda v: jc.device_sendrecv(v, perm, "data"),
                         lambda v: tc.device_sendrecv(v, perm, "data"), x)
        np.testing.assert_array_equal(t, j)

    def test_barrier_rank_size(self, r):
        c = _tcomms(r)
        with c.active():
            assert [int(b) for b in tc.barrier("data")] == [r] * r
            assert tc.rank("data") == list(range(r))
            assert tc.size("data") == r
        j = _jcomms(r)
        out = j.run(lambda v: jc.barrier("data") + 0 * v[0],
                    jnp.zeros((r,), jnp.int32), in_specs=JP("data"),
                    out_specs=JP(), check_vma=False)
        assert int(out) == r

    def test_allgatherv(self, rng_np, r):
        x = _blocks(rng_np, r, 2, 3)
        sizes = list(range(1, r + 1))
        jcomm = _jcomms(r)
        jout = jcomm.run(
            lambda v, s: jc.allgatherv(v, s[0], "data"),
            jax.device_put(jnp.asarray(x), jcomm.row_sharded()),
            jax.device_put(jnp.asarray(sizes, jnp.int32),
                           jcomm.row_sharded()),
            in_specs=(JP("data"), JP("data")),
            out_specs=(JP("data"), JP("data")), check_vma=False)
        c = _tcomms(r)
        with c.active():
            st, sz = tc.allgatherv(c.shard(torch.as_tensor(x)), sizes, "data")
        np.testing.assert_array_equal(c.assemble(st).numpy(),
                                      np.asarray(jout[0]))
        np.testing.assert_array_equal(c.assemble(sz).numpy(),
                                      np.asarray(jout[1]))


@pytest.mark.parametrize("r", R_VALUES)
class TestQuantizedWires:
    @pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("n", [100, 300])
    def test_allreduce_quantized(self, rng_np, r, wire, n):
        x = _blocks(rng_np, r, 4, n)
        j, t = _run_both(
            r, lambda v: jc.allreduce_quantized(v, jc.Op.SUM, "data", wire),
            lambda v: tc.allreduce_quantized(v, tc.Op.SUM, "data", wire), x)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
    def test_integer_payload_rides_exact(self, rng_np, r, wire):
        x = _blocks(rng_np, r, 4, 9, "i")
        j, t = _run_both(
            r, lambda v: jc.allreduce_quantized(v, jc.Op.SUM, "data", wire),
            lambda v: tc.allreduce_quantized(v, tc.Op.SUM, "data", wire), x)
        np.testing.assert_array_equal(t, j)
        j, t = _run_both(
            r, lambda v: jc.reducescatter_quantized(v, jc.Op.SUM, "data",
                                                    wire),
            lambda v: tc.reducescatter_quantized(v, tc.Op.SUM, "data", wire),
            np.tile(x, (r, 1)))
        np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
    def test_reducescatter_quantized(self, rng_np, r, wire):
        x = _blocks(rng_np, r, 2 * r, 130)
        j, t = _run_both(
            r, lambda v: jc.reducescatter_quantized(v, jc.Op.SUM, "data",
                                                    wire),
            lambda v: tc.reducescatter_quantized(v, tc.Op.SUM, "data", wire),
            x)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("with_ref", [False, True])
    def test_allgather_quantized(self, rng_np, r, wire, with_ref):
        x = _blocks(rng_np, r, 3, 40) * 10

        def jb(v):
            return jc.allgather_quantized(
                v[:, :8], "data", wire, scale_ref=v if with_ref else None)

        def tb(v):
            return tc.allgather_quantized(
                [b[:, :8] for b in v], "data", wire,
                scale_ref=v if with_ref else None)

        j, t = _run_both(r, jb, tb, x)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-5)
        if wire == "int8":
            # the codes behind the values are equal: recover them
            ref = x.reshape(r, 3, 40) if with_ref else x.reshape(
                r, 3, 40)[..., :8]
            lo = ref.min(-1, keepdims=True)
            span = ref.max(-1, keepdims=True) - lo
            vals = t.reshape(r, r, 3, 8)[0]
            codes = np.round((vals - lo) / span * 254.0) - 127.0
            jvals = j.reshape(r, r, 3, 8)[0]
            jcodes = np.round((jvals - lo) / span * 254.0) - 127.0
            np.testing.assert_array_equal(codes, jcodes)

    def test_narrow_wires_are_sum_only(self, rng_np, r):
        c = _tcomms(r)
        x = c.shard(torch.as_tensor(_blocks(rng_np, r, 2, 4)))
        with c.active(), pytest.raises(ValueError, match="SUM-only"):
            tc.allreduce_quantized(x, tc.Op.MAX, "data", "int8")


@pytest.mark.parametrize("n,block", [(100, 128), (300, 128), (256, 64)])
def test_quantize_blocks_codes_equal_jax(rng_np, n, block):
    x = (rng_np.standard_normal((5, n)) * 3).astype(np.float32)
    x[1] = 0.0                        # a zero block: the tiny scale
    q, s = tc._quantize_blocks(torch.as_tensor(x), block)
    jq, js = jc._quantize_blocks(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "x"])
def test_wire_resolvers_match_jax(wire):
    for fn in ("resolve_reduce_wire_dtype", "resolve_probe_wire_dtype"):
        if wire == "x":
            with pytest.raises(ValueError):
                getattr(tc, fn)(wire)
            with pytest.raises(ValueError):
                getattr(jc, fn)(wire)
        else:
            assert getattr(tc, fn)(wire) == getattr(jc, fn)(wire)
    if wire in ("f32", "bf16"):
        assert str(tc.resolve_wire_dtype(wire)).split(".")[-1] == \
            jnp.dtype(jc.resolve_wire_dtype(wire)).name
    assert tc.WIRE_DTYPES == jc.WIRE_DTYPES
    assert tc.PROBE_WIRE_DTYPES == jc.PROBE_WIRE_DTYPES
    assert tc.REDUCE_WIRE_DTYPES == jc.REDUCE_WIRE_DTYPES
    assert tc.QUANT_BLOCK == jc.QUANT_BLOCK


@pytest.mark.parametrize("r", R_VALUES)
def test_ledger_counts_per_call(rng_np, r):
    c = _tcomms(r)
    x = c.shard(torch.as_tensor(_blocks(rng_np, r, 3, 5)))
    tracing.reset_counters("comms.")
    with c.active():
        tc.allreduce(x, tc.Op.SUM, "data")
        tc.allreduce(x, tc.Op.SUM, "data")
        tc.allgather_quantized(x, "data", "int8")
    cnt = tracing.counters("comms.")
    assert cnt["comms.allreduce.calls"] == 2.0
    assert cnt["comms.allreduce.modeled_bytes"] == 2.0 * 3 * 5 * 4
    # int8 codes + two f32 planes a row, one shard's payload
    assert cnt["comms.allgather_quantized.modeled_bytes"] == 3 * 5 + 3 * 8


def test_timed_dispatch_records_a_span():
    tracing.reset_spans()
    tracing.reset_counters("comms.dispatch.")
    out = tc.timed_dispatch("fam", lambda: 7, "data", modeled_bytes=12.0,
                            trace_ids=(3,))
    assert out == 7
    spans = [s for s in tracing.span_recorder().spans()
             if s.name == "comms.dispatch.fam"]
    assert len(spans) == 1 and spans[0].attrs["modeled_bytes"] == 12.0
    assert tracing.get_counter("comms.dispatch.fam.calls") == 1.0


@pytest.mark.parametrize("r", R_VALUES)
def test_self_tests_and_split(r):
    c = _tcomms(r)
    assert c.test_allreduce() and c.test_bcast(r - 1)
    assert c.test_pointToPoint_simple_send_recv()
    grid = local_comms(("lists", "queries"), shape=(r, 2), device="cpu")
    assert grid.size == r and grid.split("queries").size == 2
    assert grid.test_allreduce() and grid.split("queries").test_bcast(1)
    with pytest.raises(ValueError):
        grid.split("nope")


def test_mesh_groups_follow_the_grid():
    m = tc.Mesh(np.full((4, 2), "cpu", dtype=object), ("lists", "queries"))
    assert m.groups("lists") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert m.groups("queries") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.coord(5, "lists") == 2 and m.coord(5, "queries") == 1


def test_shard_assemble_round_trip(rng_np):
    grid = local_comms(("lists", "queries"), shape=(4, 2), device="cpu")
    x = torch.as_tensor(rng_np.standard_normal((8, 6)).astype(np.float32))
    for spec in (P("lists"), P("queries", None), P("lists", "queries"),
                 P()):
        assert torch.equal(grid.assemble(grid.shard(x, spec), spec), x)


def test_collective_outside_a_scope_raises():
    with pytest.raises(RaftError, match="needs a mesh"):
        tc.allreduce([torch.zeros(2)], tc.Op.SUM, "data")


def test_mesh_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is valid here")
    with pytest.raises(RaftError):
        local_comms(shape=(2,))
