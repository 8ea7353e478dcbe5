"""raft_tpu_torch.io against the JAX package's raft_tpu.io: the same
``.fbin/.u8bin/.i8bin/.ibin`` files on the native and numpy paths, files
written by one package read by the other, and the chunk pipeline."""

import threading

import numpy as np
import pytest

import raft_tpu.io as jio
from raft_tpu_torch.core import interruptible
from raft_tpu_torch.io import BinDataset, native_available, read_bin, write_bin

SUFFIXES = [("fbin", np.float32), ("u8bin", np.uint8), ("i8bin", np.int8),
            ("ibin", np.int32)]


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def use_native(request):
    if request.param and not native_available():
        pytest.skip("the native IO library cannot be built here (no g++)")
    return request.param


def _data(rng, shape, dt):
    if np.dtype(dt).kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(max(info.min, -1000), min(info.max, 1000),
                        shape).astype(dt)


class TestBinFile:
    @pytest.mark.parametrize("suffix,dt", SUFFIXES,
                             ids=[s for s, _ in SUFFIXES])
    def test_roundtrip_every_suffix(self, tmp_path, rng_np, use_native,
                                    suffix, dt):
        data = _data(rng_np, (37, 9), dt)
        p = tmp_path / f"x.{suffix}"
        assert write_bin(p, data, use_native=use_native) == use_native
        with BinDataset(p, use_native=use_native) as ds:
            assert ds.shape == (37, 9) and ds.native == use_native
            assert ds.dtype == np.dtype(dt)
            np.testing.assert_array_equal(ds.read(), data)

    def test_windowed_read(self, tmp_path, rng_np, use_native):
        data = rng_np.standard_normal((64, 8)).astype(np.float32)
        p = tmp_path / "x.fbin"
        write_bin(p, data, use_native=use_native)
        with BinDataset(p, use_native=use_native) as ds:
            np.testing.assert_array_equal(ds.read(10, 20), data[10:30])
            np.testing.assert_array_equal(ds.read(63, 1), data[63:64])
            np.testing.assert_array_equal(read_bin(p, 5, 3,
                                                   use_native=use_native),
                                          data[5:8])

    @pytest.mark.parametrize("start,n", [(5, 20), (-1, 2), (0, 11)])
    def test_out_of_bounds(self, tmp_path, rng_np, use_native, start, n):
        data = rng_np.standard_normal((10, 4)).astype(np.float32)
        p = tmp_path / "x.fbin"
        write_bin(p, data, use_native=use_native)
        with BinDataset(p, use_native=use_native) as ds:
            with pytest.raises(IndexError):
                ds.read(start, n)

    def test_truncated_file_rejected(self, tmp_path, use_native):
        p = tmp_path / "bad.fbin"
        with open(p, "wb") as fh:
            np.asarray([1000, 128], np.int32).tofile(fh)
            np.zeros(10, np.float32).tofile(fh)
        with pytest.raises(IOError):
            BinDataset(p, use_native=use_native)

    def test_unknown_suffix(self, tmp_path, rng_np):
        with pytest.raises(ValueError):
            BinDataset(tmp_path / "x.weird")
        with pytest.raises(ValueError):
            write_bin(tmp_path / "x.weird", np.zeros((2, 2), np.float32))

    def test_write_needs_2d(self, tmp_path, use_native):
        with pytest.raises(ValueError):
            write_bin(tmp_path / "x.fbin", np.zeros(4, np.float32),
                      use_native=use_native)

    def test_threaded_large_read(self, tmp_path, rng_np, use_native):
        data = rng_np.standard_normal((40000, 32)).astype(np.float32)
        p = tmp_path / "big.fbin"
        write_bin(p, data, use_native=use_native)
        with BinDataset(p, use_native=use_native) as ds:
            np.testing.assert_array_equal(ds.read(n_threads=8), data)


class TestAcrossPackages:
    """The same bytes: the port reads what the JAX package writes and the
    other way round, on every path of both."""

    @pytest.mark.parametrize("suffix,dt", SUFFIXES,
                             ids=[s for s, _ in SUFFIXES])
    def test_jax_writes_port_reads(self, tmp_path, rng_np, use_native,
                                   suffix, dt):
        data = _data(rng_np, (50, 12), dt)
        p = tmp_path / f"j.{suffix}"
        jio.write_bin(p, data, use_native=False)
        np.testing.assert_array_equal(read_bin(p, use_native=use_native),
                                      data)

    @pytest.mark.parametrize("suffix,dt", SUFFIXES,
                             ids=[s for s, _ in SUFFIXES])
    def test_port_writes_jax_reads(self, tmp_path, rng_np, use_native,
                                   suffix, dt):
        data = _data(rng_np, (50, 12), dt)
        p = tmp_path / f"t.{suffix}"
        write_bin(p, data, use_native=use_native)
        np.testing.assert_array_equal(jio.read_bin(p, use_native=False),
                                      data)

    def test_files_are_byte_identical(self, tmp_path, rng_np, use_native):
        data = rng_np.standard_normal((33, 7)).astype(np.float32)
        write_bin(tmp_path / "t.fbin", data, use_native=use_native)
        jio.write_bin(tmp_path / "j.fbin", data, use_native=False)
        assert ((tmp_path / "t.fbin").read_bytes()
                == (tmp_path / "j.fbin").read_bytes())


class TestPipeline:
    @pytest.mark.parametrize("chunk", [1, 192, 1000, 4096])
    def test_iter_chunks(self, tmp_path, rng_np, use_native, chunk):
        x = rng_np.standard_normal((1000, 16)).astype(np.float32)
        path = tmp_path / "d.fbin"
        write_bin(path, x, use_native=use_native)
        got = np.empty_like(x)
        starts = []
        with BinDataset(path, use_native=use_native) as ds:
            for first, c in ds.iter_chunks(chunk):
                got[first:first + c.shape[0]] = c
                starts.append(first)
        np.testing.assert_array_equal(got, x)
        assert starts == list(range(0, 1000, chunk))

    def test_iter_chunks_equal_jax(self, tmp_path, rng_np, use_native):
        x = rng_np.standard_normal((700, 8)).astype(np.float32)
        path = tmp_path / "d.fbin"
        write_bin(path, x, use_native=use_native)
        with BinDataset(path, use_native=use_native) as ds, \
                jio.BinDataset(path, use_native=False) as jds:
            for (f1, c1), (f2, c2) in zip(ds.iter_chunks(256),
                                          jds.iter_chunks(256)):
                assert f1 == f2
                np.testing.assert_array_equal(c1, c2)

    def test_iter_chunks_nocopy_view(self, tmp_path, rng_np):
        if not native_available():
            pytest.skip("the native IO library cannot be built here")
        x = rng_np.standard_normal((300, 8)).astype(np.float32)
        path = tmp_path / "d.fbin"
        write_bin(path, x, use_native=True)
        with BinDataset(path, use_native=True) as ds:
            for first, chunk in ds.iter_chunks(100, copy=False):
                np.testing.assert_array_equal(
                    chunk, x[first:first + chunk.shape[0]])

    def test_iter_chunks_rejects_nonpositive(self, tmp_path, use_native):
        path = tmp_path / "d.fbin"
        write_bin(path, np.zeros((4, 2), np.float32), use_native=use_native)
        with BinDataset(path, use_native=use_native) as ds:
            with pytest.raises(ValueError):
                next(ds.iter_chunks(0))


class TestInterruptible:
    def test_cancel_then_yield_raises_once(self):
        interruptible.cancel()
        with pytest.raises(interruptible.InterruptedException):
            interruptible.yield_()
        interruptible.yield_()          # the flag was consumed

    def test_yield_no_throw(self):
        assert not interruptible.yield_no_throw()
        interruptible.cancel(threading.get_ident())
        assert interruptible.yield_no_throw()
        assert not interruptible.yield_no_throw()

    def test_cancel_another_thread(self):
        seen = []
        armed = threading.Event()
        go = threading.Event()

        def worker():
            armed.set()
            go.wait(10)
            try:
                interruptible.synchronize()
            except interruptible.InterruptedException:
                seen.append(True)

        t = threading.Thread(target=worker)
        t.start()
        armed.wait(10)
        interruptible.cancel(t.ident)
        go.set()
        t.join(10)
        assert not t.is_alive() and seen == [True]


def test_use_native_true_raises_without_the_library(tmp_path, monkeypatch):
    from raft_tpu_torch.io import binfile

    monkeypatch.setattr(binfile, "_load_native", lambda: None)
    with pytest.raises(IOError):
        write_bin(tmp_path / "x.fbin", np.zeros((2, 2), np.float32),
                  use_native=True)
    # None falls back to numpy
    assert not write_bin(tmp_path / "x.fbin", np.zeros((2, 2), np.float32))
    with pytest.raises(IOError):
        BinDataset(tmp_path / "x.fbin", use_native=True)
