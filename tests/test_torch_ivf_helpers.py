"""The port's index helpers against ``raft_tpu.neighbors.ivf_helpers``:
list unpacking (IVF-Flat and IVF-PQ, nibble-packed codes expanded), the
functional list repack of IVF-Flat, the PQ decoder and the centers, on
indexes carried across by ``save``/``load``. The decoder is a gather and
one product on integer codebooks and centers: exact."""

from __future__ import annotations

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.neighbors import ivf_helpers as j_help
from raft_tpu.neighbors import ivf_pq as j_pq
from raft_tpu_torch import Resources
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.neighbors import ivf_flat, ivf_helpers, ivf_pq

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return rng.integers(-6, 7, (500, 16)).astype(np.float32)


def _carry(j_mod, t_mod, jidx):
    buf = io.BytesIO()
    j_mod.save(jidx, buf)
    buf.seek(0)
    return t_mod.load(CPU, buf)


@pytest.fixture(scope="module")
def flat(data):
    ji = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=6), data)
    return ji, _carry(j_ivf, ivf_flat, ji)


@pytest.fixture(scope="module", params=[(4, 0), (8, 1)],
                ids=["4bit-per_subspace", "8bit-per_cluster"])
def pq(request, data):
    bits, kind = request.param
    empty = j_pq.build(None, j_pq.IvfPqIndexParams(
        n_lists=6, pq_dim=8, pq_bits=bits, add_data_on_build=False,
        codebook_kind=j_pq.CodebookKind(kind)), data)
    empty = dataclasses.replace(empty, centers=jnp.round(empty.centers),
                                codebooks=jnp.round(empty.codebooks))
    ji = j_pq.extend(None, empty, data)
    return ji, _carry(j_pq, ivf_pq, ji)


@pytest.mark.parametrize("label", [0, 3, 5])
def test_flat_unpack_equals_reference(flat, label):
    ji, ti = flat
    jv, jids = j_help.flat_unpack_list_data(ji, label)
    tv, tids = ivf_helpers.flat_unpack_list_data(ti, label)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())


def test_flat_pack_equals_reference_and_leaves_the_old_index(flat, data):
    ji, ti = flat
    before = ti.data.clone()
    vec = data[:7] + 1
    ids = np.arange(900, 907, dtype=np.int32)
    jn = j_help.flat_pack_list_data(ji, 2, vec, ids)
    tn = ivf_helpers.flat_pack_list_data(ti, 2, vec, ids)
    for f in ("data", "data_norms", "indices", "list_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(jn, f)),
                                      getattr(tn, f).numpy(), err_msg=f)
    assert torch.equal(ti.data, before)
    with pytest.raises(RaftError, match="overflow"):
        ivf_helpers.flat_pack_list_data(
            ti, 2, np.zeros((ti.max_list_size + 1, 16), np.float32),
            np.zeros(ti.max_list_size + 1, np.int32))
    with pytest.raises(RaftError, match="bad list id"):
        ivf_helpers.flat_unpack_list_data(ti, 6)


@pytest.mark.parametrize("label", [0, 4])
def test_pq_unpack_and_reconstruct_equal_reference(pq, label):
    ji, ti = pq
    jc, jids = j_help.pq_unpack_list_data(ji, label)
    tc, tids = ivf_helpers.pq_unpack_list_data(ti, label)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    assert tc.shape[1] == ti.pq_dim
    np.testing.assert_array_equal(
        np.asarray(j_help.pq_reconstruct_list_data(ji, label)),
        ivf_helpers.pq_reconstruct_list_data(ti, label).numpy())
    assert torch.equal(ivf_helpers.pq_extract_centers(ti), ti.centers)
