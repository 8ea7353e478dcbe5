"""The port's graftlint (``raft_tpu_torch/analysis``): a violating and a
conforming fixture for every rule; parity with the JAX package's lint on
the rules that carry over (R0, R3, R5, R7, R8, R9) and on the pragma
parser; scope proofs on the port's own sources; the repo-wide gate (the
port lints clean, its suppressions are snapshot and used, its lock graph
is acyclic); and the CLI in a process where JAX and the JAX package
cannot be imported.

Fixture texts carry no literal tab or trailing space (the JAX lint scans
this file): those characters are built with escapes and concatenation.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

import raft_tpu.analysis as j_analysis
from raft_tpu.analysis.core import parse_pragma_items as j_parse_pragmas
from raft_tpu_torch.analysis import (
    RULES,
    Project,
    lint_texts,
    parse_pragma_items,
    run,
)
from raft_tpu_torch.analysis import __main__ as cli
from raft_tpu_torch.analysis.core import BENCH_GATE, METRICS_DOC
from raft_tpu_torch.analysis.rules_locks import build_lock_graph

# one intra-op thread, as in every port test file: tier-1 runs the files
# in parallel workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "raft_tpu_torch"
TAB = "\t"
SPACE = " "


def lines_of(report, rule=None):
    return {(f.rule, f.line) for f in report.findings
            if rule is None or f.rule == rule}


def lint_one(src, rules, rel=PKG + "/ops/sample.py", aux=None):
    return lint_texts({rel: src}, rules=rules, aux=aux)


# ---------------------------------------------------------------------------
# (a) fixture corpus — VIOLATING / CONFORMING per rule
# ---------------------------------------------------------------------------

R0_VIOLATING = (
    "import os\n"
    "x = 1" + SPACE + "\n"
    "y = 2" + TAB + "\n"
    "print(x, y)\n"
    "\n"
    "\n"
    "def stub():\n"
    "    raise NotImplementedError\n"
)
R0_CONFORMING = "import os\n\nx = os.getpid()\n"

R1_VIOLATING = '''\
import torch


def _score_fn(queries, data, *, k: int):
    total = queries + data
    if total.sum() > 0:
        return total
    for _ in range(data[0, 0]):
        total = total * 2
    worst = queries.max().item()
    return total, worst
'''
R1_CONFORMING = '''\
import torch


def _score_fn(queries, data, filter_words=None, *, k: int,
              engine: str = "cuda"):
    if queries.ndim == 2 and filter_words is None:
        queries = queries + data
    if engine == "torch" or k > 4:
        return data
    for _ in range(queries.size(0)):
        queries = queries * 2
    for row in data:
        queries = queries + row
    return queries
'''
R1_KEY_VIOLATING = '''\
def _plan(statics, arrays):
    key = ("ivf", [s for s in statics], float(arrays))
    return key
'''
R1_KEY_CONFORMING = '''\
def _plan(statics, arrays):
    key = ("ivf", tuple(sorted(statics)), len(arrays))
    return key
'''
R1_CAPTURE_CLOSURE = '''\
import torch


class Executor:
    def _capture_locked(self, static_q):
        def body(q):
            if q.any():
                return q
            return q * 2

        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        out = body(static_q)
        graph.capture_end()
        return graph, out
'''

R2_VIOLATING = '''\
import threading

import torch


class Executor:
    def __init__(self):
        self._lock = threading.Lock()

    def search(self, entry, q):
        with self._lock:
            entry.static_q.copy_(q)
            entry.graph.replay()
            return entry.outputs[0]

    def peek(self, entry):
        return entry.outputs[1].clone()

    def refresh(self, entry, q):
        entry.static_q = q

    def _capture_locked(self, entry, q):
        entry.static_q = torch.zeros_like(q)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        entry.outputs = (entry.static_q * 2, entry.static_q)
        graph.capture_end()
        entry.graph = graph
'''
R2_CONFORMING = '''\
import threading

import torch


class Executor:
    def __init__(self):
        self._lock = threading.Lock()

    def search(self, entry, q):
        with self._lock:
            if entry.outputs is None:
                self._capture_locked(entry, q)
            return self._replay_locked(entry, q)

    def _replay_locked(self, entry, q):
        entry.static_q.copy_(q)
        entry.static_nv.fill_(q.shape[0])
        entry.graph.replay()
        return entry.outputs[0][:q.shape[0]].clone()

    def _capture_locked(self, entry, q):
        entry.static_q = torch.zeros_like(q)
        entry.static_nv = torch.zeros((), dtype=torch.int32)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        entry.outputs = (entry.static_q * 2,)
        graph.capture_end()
        entry.graph = graph
'''

R3_VIOLATING = '''\
import torch
import torch.distributed as dist
from torch.distributed import all_gather_into_tensor


def merge(x, out):
    torch.distributed.all_reduce(x)
    dist.broadcast(x, 0)
    all_gather_into_tensor(out, x)
    return getattr(torch.distributed, "reduce_scatter_tensor")


def meet():
    d = torch.distributed
    d.barrier()
'''
R3_CONFORMING = '''\
import torch
import torch.distributed as dist


def process():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return torch.distributed.get_rank, 1
'''

R4_VIOLATING = """\
constexpr int kThreads = 256;
constexpr int kRows = 128;

__global__ void unbounded(float* x) { x[threadIdx.x] = 0.f; }

__global__ void __launch_bounds__(kThreads) dyn(float* x) {
  extern __shared__ float smem[];
  smem[threadIdx.x] = x[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads) forgotten(float* x) {
  extern __shared__ float smem[];
  x[threadIdx.x] = smem[0];
}

__global__ void __launch_bounds__(kThreads) big(float* x) {
  __shared__ float tile[kRows][kRows];
  tile[0][threadIdx.x] = x[0];
}

int launch(float* x, int bytes) {
  cudaFuncSetAttribute(dyn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  dyn<<<1, kThreads, bytes>>>(x);
  forgotten<<<1, kThreads, bytes>>>(x);
  return 0;
}
"""
R4_CONFORMING = """\
constexpr int kThreads = 256;
constexpr int kRows = 32;

// a comment that names __global__ is not a kernel
__global__ void __launch_bounds__(kThreads) dyn(float* x) {
  extern __shared__ float smem[];
  smem[threadIdx.x] = x[threadIdx.x];
}

template <int S>
__global__ void __launch_bounds__(kThreads, 2) small(float* x) {
  __shared__ float tile[kRows][kRows];
  __shared__ int count;
  tile[0][threadIdx.x] = x[0];
  count = S;
}

cudaError_t launch(float* x, int bytes) {
  void (*kernel)(float*) = dyn;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, bytes>>>(x);
  small<4><<<1, kThreads>>>(x);
  return cudaGetLastError();
}
"""

R5_VIOLATING = '''\
import numpy as np
import torch


def _scan_fn(queries, data, *, k: int):
    n = float(queries.sum())
    host = np.asarray(data)
    return queries, n, host


def search(res, index, queries, k):
    worst = queries.max().item()
    ids = index.ids.tolist()
    torch.cuda.synchronize()
    if (queries < 0).any():
        return None
    return worst, ids, queries.cpu().numpy()


def place(blocks, dev):
    out = []
    for b in blocks:
        out.append(torch.tensor(b, device=dev))
        out.append(b.to("cpu"))
    return out
'''
R5_CONFORMING = '''\
import numpy as np
import torch


def _scan_fn(queries, data, *, k: int):
    n = queries.sum()
    return queries + data, n


def search(res, index, queries, k):
    worst = queries.max()
    return torch.where(queries < 0, worst, queries), queries.shape[0]


def build(res, rows):
    total = rows.sum().item()
    return np.asarray(rows.cpu()), total


def place(blocks, dev):
    return torch.tensor(np.stack(blocks), device=dev).to("cpu")
'''

R6_EXECUTOR = '''\
def _kernel_wrappers() -> dict:
    from raft_tpu_torch.ops.sample import scan

    return {"scan": scan}
'''
R6_OPS_CONFORMING = '''\
def _scan_torch(x):
    return x


def _scan_cuda(x):
    from raft_tpu_torch.ops import _build

    launch = _build.load("scan")
    scan.launches += 1
    return launch(x)


def scan(x, engine="torch"):
    if engine == "torch" or x.device.type == "cpu":
        return _scan_torch(x)
    return _scan_cuda(x)


scan.launches = 0
'''
R6_OPS_VIOLATING = '''\
def scan(x, engine="torch"):
    scan.launches += 1
    return x


scan.launches = 0
'''
R6_CUDA_TEST = '''\
from raft_tpu_torch.ops.sample import scan


def test_scan():
    scan(None, engine="cuda")
'''
R6_SMOKE = '''\
def kernels_scan(torch):
    from raft_tpu_torch.ops.sample import scan

    return scan(torch.zeros(4))


def phase_kernels(torch, seed):
    kernels_scan(torch)
'''

R7_VIOLATING = '''\
import time


def stamp():
    return time.monotonic(), time.time()
'''
R7_CONFORMING = '''\
import time


class MonotonicClock:
    def now(self):
        return time.monotonic()


def stamp(clock):
    time.sleep(0)
    return clock.now()
'''

R8_VIOLATING = '''\
import threading


class Depot:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: _lock

    def bump(self):
        with self._lock:
            self._n += 1

    def peek(self):
        return self._n


_a = threading.Lock()
_b = threading.Lock()


def left():
    with _a:
        with _b:
            pass


def right():
    with _b:
        with _a:
            pass
'''
R8_CONFORMING = '''\
import threading


class Depot:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  # guarded-by: _lock

    def bump(self):
        with self._lock:
            self._bump_locked()

    def _bump_locked(self):
        self._n += 1

    def peek(self):
        with self._lock:
            return self._n


_a = threading.Lock()
_b = threading.Lock()


def left():
    with _a:
        with _b:
            pass


def right():
    with _a:
        with _b:
            pass
'''

R9_LIB = '''\
from @pkg@.core import tracing


def record(n, split):
    tracing.inc_counter("serving.sample.calls", n)
    tracing.inc_counter(f"serving.sample.{split}.rows", n)
    tracing.set_gauge("serving.sample.depth", n)
'''
R9_DOC_OK = (
    "## Metric inventory\n"
    "\n"
    "| family | kind | meaning |\n"
    "|---|---|---|\n"
    "| `serving.sample.calls` | counter | total calls |\n"
    "| `serving.sample.<split>.rows` | counter | rows per split |\n"
    "| `serving.sample.depth` | gauge | queue depth |\n"
)
R9_DOC_MISSING_GAUGE = R9_DOC_OK.replace(
    "| `serving.sample.depth` | gauge | queue depth |\n", "")
R9_FLOORS_DEAD = (
    "SNAPSHOT_FLOORS = {\n"
    '    "serving.sample.calls": 10,\n'
    '    "serving.sample.ghost": 1,\n'
    "}\n"
)
R9_EXPORTER_DEAD = (
    "_HELP_PREFIXES = (\n"
    '    ("serving.sample", "sample family"),\n'
    '    ("serving.ghostly", "nothing registers this"),\n'
    ")\n"
)


class TestFixtureCorpus:
    """Each rule fires on its violating sample and stays quiet on the
    conforming one."""

    def test_registry_is_r0_to_r9_with_the_port_names(self):
        assert sorted(RULES) == [f"R{i}" for i in range(10)]
        assert {r: RULES[r].name for r in ("R1", "R2", "R4", "R6")} == {
            "R1": "capture-hazard", "R2": "graph-buffer-aliasing",
            "R4": "launch-budget", "R6": "plain-twin-coverage"}

    def test_r0(self):
        bad = lint_one(R0_VIOLATING, ["R0"])
        msgs = " ".join(f.message for f in bad.findings)
        for what in ("unused import", "trailing whitespace", "tab",
                     "print()", "NotImplementedError"):
            assert what in msgs, msgs
        assert lint_one(R0_CONFORMING, ["R0"]).ok
        # outside the package, print is fine
        assert lint_one("print(1)\n", ["R0"], rel="chip_smoke.py").ok

    def test_r0_pragma_hygiene_and_csrc_whitespace(self):
        rep = lint_one("x = 1  # graftlint: disable=R5\n", ["R0", "R5"])
        assert any("carries no reason" in f.message for f in rep.findings)
        rep = lint_one("x = 1  # graftlint: disable=R5(nothing here)\n",
                       ["R0", "R5"])
        assert any("unused suppression" in f.message for f in rep.findings)
        rep = lint_one("int x;" + SPACE + "\n", ["R0"],
                       rel=PKG + "/csrc/sample.cu")
        assert lines_of(rep) == {("R0", 1)}

    def test_r1_capture_hazards(self):
        bad = lint_one(R1_VIOLATING, ["R1"])
        assert lines_of(bad) == {("R1", 6), ("R1", 8), ("R1", 10)}
        msgs = " ".join(f.message for f in bad.findings)
        assert "`if`" in msgs and "range()" in msgs and ".item()" in msgs
        assert lint_one(R1_CONFORMING, ["R1"]).ok

    def test_r1_eager_bodies_are_named_not_captured(self):
        src = R1_VIOLATING.replace("_score_fn", "_tiered_search_fn")
        assert not lint_one(src, ["R1"]).ok
        assert lint_one(src, ["R1"], rel=PKG + "/neighbors/tiered.py").ok

    def test_r1_the_closure_handed_to_capture_begin(self):
        bad = lint_one(R1_CAPTURE_CLOSURE, ["R1"],
                       rel=PKG + "/core/executor.py")
        assert lines_of(bad) == {("R1", 7)}
        assert "graph-capture" in bad.findings[0].message

    def test_r1_cache_key(self):
        bad = lint_one(R1_KEY_VIOLATING, ["R1"])
        msgs = " ".join(f.message for f in bad.findings)
        assert "unhashable" in msgs and "float()" in msgs, msgs
        assert lint_one(R1_KEY_CONFORMING, ["R1"]).ok

    def test_r2(self):
        bad = lint_one(R2_VIOLATING, ["R2"], rel=PKG + "/core/executor.py")
        assert lines_of(bad) == {("R2", 14), ("R2", 17), ("R2", 20)}
        msgs = [f.message for f in sorted(bad.findings,
                                          key=lambda f: f.line)]
        assert "without .clone()" in msgs[0]
        assert "without the executor lock" in msgs[1]
        assert "rebound" in msgs[2]
        assert lint_one(R2_CONFORMING, ["R2"],
                        rel=PKG + "/core/executor.py").ok

    def test_r3(self):
        bad = lint_one(R3_VIOLATING, ["R3"],
                       rel=PKG + "/distributed/sample.py")
        assert lines_of(bad) == {("R3", n) for n in (7, 8, 9, 10, 15)}
        assert lint_one(R3_CONFORMING, ["R3"],
                        rel=PKG + "/distributed/sample.py").ok
        # the veneer itself may call torch.distributed
        assert lint_one(R3_VIOLATING, ["R3"],
                        rel=PKG + "/comms/comms.py").ok

    def test_r4(self):
        rel = PKG + "/csrc/sample.cu"
        bad = lint_one(R4_VIOLATING, ["R4"], rel=rel)
        assert lines_of(bad) == {("R4", 4), ("R4", 11), ("R4", 16),
                                 ("R4", 22)}
        msgs = " ".join(f.message for f in bad.findings)
        assert "no __launch_bounds__" in msgs
        assert "forgotten declares extern __shared__" in msgs
        assert "65536 bytes of static __shared__" in msgs
        assert "error is dropped" in msgs
        assert lint_one(R4_CONFORMING, ["R4"], rel=rel).ok

    def test_r4_opt_in_in_an_included_header_and_csrc_pragmas(self):
        header = R4_CONFORMING.replace("constexpr int kThreads = 256;\n",
                                       "")
        unit = ('#include "sample.cuh"\n'
                "constexpr int kThreads = 256;\n")
        rep = lint_texts({PKG + "/csrc/sample.cuh": header,
                          PKG + "/csrc/sample.cu": unit}, rules=["R4"])
        assert rep.ok, [f.render() for f in rep.findings]
        src = R4_VIOLATING.replace(
            "__global__ void unbounded",
            "// graftlint: disable=R4(a one-thread test kernel)\n"
            "__global__ void unbounded")
        rep = lint_one(src, ["R0", "R4"], rel=PKG + "/csrc/sample.cu")
        assert ("R4", 5) not in lines_of(rep)
        assert [s.reason for s in rep.suppressions] == [
            "a one-thread test kernel"]
        assert all(s.used for s in rep.suppressions)

    def test_r5(self):
        bad = lint_one(R5_VIOLATING, ["R5"])
        assert lines_of(bad) == {("R5", n) for n in (
            6, 7, 12, 13, 14, 15, 17, 23, 24)}
        assert lint_one(R5_CONFORMING, ["R5"]).ok
        # the same source outside the hot modules stays quiet
        assert lint_one(R5_VIOLATING, ["R5"], rel=PKG + "/io/sample.py").ok

    def test_r6(self):
        texts = {PKG + "/core/executor.py": R6_EXECUTOR,
                 PKG + "/ops/sample.py": R6_OPS_CONFORMING,
                 "tests/test_torch_cuda_sample.py": R6_CUDA_TEST,
                 "chip_smoke.py": R6_SMOKE}
        assert lint_texts(texts, rules=["R6"]).ok
        bad = lint_texts(dict(texts, **{
            PKG + "/ops/sample.py": R6_OPS_VIOLATING,
            "tests/test_torch_cuda_sample.py": "def test_none():\n"
                                               "    pass\n",
            "chip_smoke.py": "def phase_kernels(torch, seed):\n"
                             "    pass\n"}), rules=["R6"])
        msgs = " ".join(f.message for f in bad.findings)
        assert len(bad.findings) == 4, msgs
        for what in ("launches no kernel", "no plain PyTorch version",
                     "no CUDA-gated", "phase_kernels"):
            assert what in msgs, msgs

    def test_r7(self):
        rel = PKG + "/serving/sample.py"
        assert lines_of(lint_one(R7_VIOLATING, ["R7"], rel=rel)) == {
            ("R7", 5)}
        assert lint_one(R7_CONFORMING, ["R7"], rel=rel).ok

    def test_r8(self):
        rel = PKG + "/serving/sample.py"
        bad = lint_one(R8_VIOLATING, ["R8"], rel=rel)
        msgs = " ".join(f.message for f in bad.findings)
        assert "without holding self._lock" in msgs
        assert "lock-order cycle" in msgs
        assert lint_one(R8_CONFORMING, ["R8"], rel=rel).ok

    def test_r9(self):
        rel = PKG + "/serving/sample.py"
        lib = R9_LIB.replace("@pkg@", PKG)
        assert lint_one(lib, ["R9"], rel=rel).ok   # quiet without aux
        assert lint_one(lib, ["R9"], rel=rel,
                        aux={METRICS_DOC: R9_DOC_OK}).ok
        bad = lint_one(lib, ["R9"], rel=rel,
                       aux={METRICS_DOC: R9_DOC_MISSING_GAUGE,
                            BENCH_GATE: R9_FLOORS_DEAD})
        assert {(f.path, f.line) for f in bad.findings} == {
            (rel, 7), (BENCH_GATE, 3)}
        bad = lint_texts({rel: lib,
                          PKG + "/serving/exporter.py": R9_EXPORTER_DEAD},
                         rules=["R9"], aux={METRICS_DOC: R9_DOC_OK})
        assert lines_of(bad) == {("R9", 3)}
        assert "dead HELP text" in bad.findings[0].message


# ---------------------------------------------------------------------------
# (b) parity with the JAX lint on the rules that carry over
# ---------------------------------------------------------------------------

# the spelling each side's rule requires, where the two differ
SIDES = {
    "jax": {"@pkg@": "raft_tpu", "@raw@": "jax.lax.psum(x, axis)",
            "@put@": "jax.device_put(b, dev)", "@lib@": "jax"},
    "torch": {"@pkg@": PKG, "@raw@": "torch.distributed.all_reduce(x)",
              "@put@": "torch.tensor(b, device=dev)", "@lib@": "torch"},
}
SHARED = {
    "R0": ("@pkg@/ops/sample.py", R0_VIOLATING + (
        "z = 3  # graftlint: disable=R5\n"
        "w = 4  # graftlint: disable=R5(nothing here)\n"), ["R0", "R5"]),
    "R3": ("@pkg@/distributed/sample.py", '''\
import @lib@
from @pkg@.comms import comms
from @pkg@.comms.comms import Mesh


def merge(x, devices, axis="data"):
    mesh = Mesh(devices, axis_names=("data",))
    y = @raw@
    comms.allreduce(x, comms.Op.SUM, "dataa")
    comms.allgather(x, "data")
    return mesh, y
''', ["R3"]),
    "R5": ("@pkg@/ops/sample.py", '''\
import numpy as np
import @lib@


def _scan_fn(queries, data, *, k: int):
    n = float(queries.sum())
    host = np.asarray(data)
    return queries, n, host


def search(res, index, queries, k):
    worst = queries.max().item()
    return worst


def place(blocks, dev):
    out = []
    for b in blocks:
        out.append(@put@)
    return out, @lib@
''', ["R5"]),
    "R7": ("@pkg@/serving/sample.py", R7_VIOLATING + R7_CONFORMING.replace(
        "import time\n", ""), ["R7"]),
    "R8": ("@pkg@/serving/sample.py", R8_VIOLATING, ["R8"]),
}


def _side(text, side):
    for k, v in SIDES[side].items():
        text = text.replace(k, v)
    return text


@pytest.mark.parametrize("rule", sorted(SHARED))
def test_parity_with_the_jax_lint(rule):
    rel, text, rules = SHARED[rule]
    got = lint_texts({_side(rel, "torch"): _side(text, "torch")},
                     rules=rules)
    want = j_analysis.lint_texts({_side(rel, "jax"): _side(text, "jax")},
                                 rules=rules)
    assert lines_of(got) == lines_of(want)
    assert lines_of(got, rule), "the fixture must fire"


def test_r9_parity_with_the_jax_lint():
    def lint(side, lint_fn, doc, gate):
        rel = _side("@pkg@/serving/sample.py", side)
        exporter = _side("@pkg@/serving/exporter.py", side)
        texts = {rel: _side(R9_LIB, side), exporter: R9_EXPORTER_DEAD}
        return lint_fn(texts, rules=["R9"], aux={
            doc: R9_DOC_MISSING_GAUGE, gate: R9_FLOORS_DEAD})

    got = lint("torch", lint_texts, METRICS_DOC, BENCH_GATE)
    want = lint("jax", j_analysis.lint_texts, "ARCHITECTURE.md",
                "ci/bench_compare.py")
    assert lines_of(got) == lines_of(want)
    assert len(got.findings) == 3


@pytest.mark.parametrize("payload", [
    "R1(keys are O(1) hashable), R5(bounded to O(block))",
    "R5(one read)",
    "R5",
    "R5(unbalanced",
    "R3(a), junk",
    "",
])
def test_pragma_parser_parity(payload):
    assert parse_pragma_items(payload) == j_parse_pragmas(payload)


# ---------------------------------------------------------------------------
# (c) scope proofs on the port's own sources
# ---------------------------------------------------------------------------


def test_item_injected_into_ivf_flat_search_body_is_r1():
    rel = PKG + "/neighbors/ivf_flat.py"
    text = (ROOT / rel).read_text()
    assert lint_texts({rel: text}, rules=["R1"]).ok
    start = text.index("def _search_impl_fn(")
    anchor = "    qf = queries.to(torch.float32)\n"
    at = text.index(anchor, start) + len(anchor)
    bad = text[:at] + "    budget = probe_counts.sum().item()\n" + text[at:]
    line = bad[:at].count("\n") + 1
    rep = lint_texts({rel: bad}, rules=["R1"])
    assert lines_of(rep) == {("R1", line)}
    assert "'_search_impl_fn'" in rep.findings[0].message


def test_uncloned_entry_output_in_executor_is_r2():
    rel = PKG + "/core/executor.py"
    text = (ROOT / rel).read_text()
    assert lint_texts({rel: text}, rules=["R2"]).ok
    good = "out_d = entry.outputs[0][:q_real].clone()"
    assert text.count(good) == 1
    bad = text.replace(good, "out_d = entry.outputs[0][:q_real]")
    line = text[:text.index(good)].count("\n") + 1
    rep = lint_texts({rel: bad}, rules=["R2"])
    assert lines_of(rep) == {("R2", line)}
    assert "without .clone()" in rep.findings[0].message


# ---------------------------------------------------------------------------
# (d) the repo-wide gate
# ---------------------------------------------------------------------------

# (path, rule, reason) of every pragma in the port — KEEP SORTED
EXPECTED_SUPPRESSIONS = [
    (PKG + "/core/executor.py", "R5",
     "tile is the ragged ladder's int tile size; float() reads no "
     "tensor"),
    (PKG + "/core/profiling.py", "R8",
     "racy read by design: a call that starts as a window opens may go "
     "untimed"),
    (PKG + "/core/tracing.py", "R0",
     "no counterpart by design: torch.profiler has no remote-capture "
     "server"),
    (PKG + "/core/tracing.py", "R8",
     "deque reference never rebinds; maxlen is immutable"),
    (PKG + "/serving/batcher.py", "R8",
     "benign racy fast-fail; the authoritative check re-runs under _cond "
     "before enqueue"),
]


@pytest.fixture(scope="module")
def repo():
    project = Project.from_root(ROOT)
    return project, run(project)


class TestRepoWide:
    def test_the_port_lints_clean(self, repo):
        _, report = repo
        assert report.ok, "\n" + "\n".join(
            f.render() for f in report.findings)

    def test_the_scan_set(self, repo):
        project, report = repo
        kinds = {f.kind for f in project.files}
        assert kinds == {"lib", "csrc", "tests", "scripts", "smoke"}
        assert all(f.rel.startswith(PKG + "/") for f in project.files
                   if f.kind in ("lib", "csrc"))
        assert all(f.rel.startswith("tests/test_torch_")
                   for f in project.tests())
        assert "chip_smoke.py" in project.by_rel
        assert PKG + "/csrc/topk_common.cuh" in project.by_rel
        assert not any(f.rel.startswith("raft_tpu/")
                       for f in project.files)
        assert report.n_files == len(project.files)

    def test_suppression_inventory_snapshot(self, repo):
        _, report = repo
        got = sorted((s.path, s.rule, s.reason)
                     for s in report.suppressions)
        assert got == sorted(EXPECTED_SUPPRESSIONS), got
        assert all(s.path.startswith(PKG + "/")
                   for s in report.suppressions)

    def test_every_suppression_is_used(self, repo):
        _, report = repo
        assert all(s.used for s in report.suppressions), [
            (s.path, s.pragma_line) for s in report.suppressions
            if not s.used]

    def test_lock_graph_is_acyclic(self, repo):
        project, _ = repo
        graph = build_lock_graph(project).to_dict()
        assert graph["cycles"] == [] and graph["self_deadlocks"] == []
        # the executor dispatches under the profiler's launch gate
        assert any(e["from"].endswith("SearchExecutor._lock")
                   and e["to"].endswith("profiling.py::_launch_gate")
                   for e in graph["edges"])


def test_cli_caches_beside_the_builds(tmp_path):
    (tmp_path / PKG / "ops").mkdir(parents=True)
    (tmp_path / PKG / "ops" / "x.py").write_text("X = 1\n")
    assert cli.main(["--root", str(tmp_path), "--format", "json"]) == 0
    assert (tmp_path / PKG / "_build" / "graftlint_cache.json").is_file()
    assert not (tmp_path / "ci").exists()


# ---------------------------------------------------------------------------
# (e) the CLI where JAX and the JAX package cannot be imported
# ---------------------------------------------------------------------------

NO_JAX = (
    "import runpy, sys\n"
    "class _Refuse:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'raft_tpu'):\n"
    "            raise ImportError('refused: ' + name)\n"
    "        return None\n"
    "sys.meta_path.insert(0, _Refuse())\n"
    "for mod in ('jax', 'raft_tpu'):\n"
    "    try:\n"
    "        __import__(mod)\n"
    "    except ImportError:\n"
    "        pass\n"
    "    else:\n"
    "        raise SystemExit(mod + ' imported')\n"
    "sys.argv = ['graftlint'] + sys.argv[1:]\n"
    "runpy.run_module('raft_tpu_torch.analysis', run_name='__main__')\n"
)


def _cli(*args):
    return subprocess.run([sys.executable, "-c", NO_JAX, *args],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)


def test_cli_runs_without_jax(tmp_path):
    out = _cli("--list-rules")
    assert out.returncode == 0, out.stderr
    ids = [ln.split()[0] for ln in out.stdout.splitlines()[1:]]
    assert ids == [f"R{i}" for i in range(10)]
    graph = tmp_path / "lockgraph.json"
    out = _cli("--format=ci", "--no-cache", "--lockgraph", str(graph))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "graftlint: OK — 0 finding(s)" in out.stdout
    assert '"cycles": []' in graph.read_text()
    assert '"self_deadlocks": []' in graph.read_text()
