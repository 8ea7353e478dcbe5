"""Device-truth attribution from ``torch.profiler`` traces — the port of
``raft_tpu/core/profiling.py``.

1. **Capture** (:func:`session`, :func:`capture_window`): a
   ``torch.profiler`` session (CPU and, with a card, CUDA activities)
   whose Chrome trace is exported into ``profile_dir`` as
   ``<host>.<ns>.pt.trace.json``. While the session runs a capture window
   is open: the executor names every call in a ``record_function`` range
   and brackets every call of a CUDA entry with a timing
   ``torch.cuda.Event`` pair (:func:`note_call`), and the measured
   milliseconds land in the trace file under :data:`CALLS_KEY`. With no
   window open nothing is named or timed. Sessions and CUDA graph
   captures exclude each other (:func:`graph_capture`).
2. **Ingestion** (:func:`load_trace`, :func:`parse_chrome_trace`,
   :func:`load_ops`): the trace's device ops are the ``"X"`` events of
   category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; their device is
   the GPU track (the process name of their ``pid``). Each op's
   annotations come from the CPU thread that launched it (its
   ``correlation`` id names the ``cuda_runtime`` launch, and the
   ``user_annotation`` ranges enclosing that launch on its thread are
   the op's) or, failing that, from the ``gpu_user_annotation`` ranges
   enclosing it on its track. ``module`` is the innermost annotation named
   ``rt_<family>_<digest>`` (the executor's entry names) and ``scope`` the
   annotation path, outermost first.
3. **Correlation** (:func:`correlate`, :func:`attribute`): ops correlate
   back to executor entries by that name (``executable_costs()``'s
   ``hlo_module``). An entry's device seconds and invocations come from
   its timed calls where the window timed any: the profiler does not
   record every kernel of a replayed CUDA graph, so a sum over the
   trace's kernels would undercount. The trace gives the per-kernel,
   per-scope and per-device breakdown where it has one, and an entry the
   trace never saw is attributed from its calls alone. Without timed
   calls (a trace of eager work, or of the CPU) the JAX package's rules
   hold: device seconds are the ops' summed durations and invocations the
   gap-clustered windows (:func:`invocation_windows`), floored by the
   least per-(device, op) count.
4. **Publication** (:func:`publish`, :class:`RollingAttribution`): the
   measured gauges, counters and ``modeled: False`` mesh spans of the JAX
   package, under its names.

``torch.profiler`` writes Chrome traces. A capture directory that holds
only an XSpace protobuf (``*.xplane.pb``, what XLA's profilers write)
is read by :func:`parse_xplane` through the stdlib decoder
:mod:`raft_tpu_torch.core.xplane`, as in the JAX package: :func:`load_ops`
takes it when the directory holds no chrome trace. Host-side file
parsing and registry writes only, apart from :func:`session`, which
drives the profiler.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import gzip
import json
import os
import socket
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from raft_tpu_torch.core import tracing, xplane

# lifetime counters: ingested captures and the totals the measured and
# modeled accountings are compared on
CAPTURES = "profiling.captures"
DEVICE_OPS = "profiling.device_ops"
ATTRIBUTED_SECONDS = "serving.attribution.device_seconds"
ATTRIBUTED_BYTES = "serving.attribution.modeled_bytes"
ATTRIBUTED_FLOPS = "serving.attribution.modeled_flops"
ROLLING_FOLDS = "profiling.rolling.folds"
ROLLING_PREFIX = "serving.attribution.rolling."

# the mesh phase markers an annotation path may carry; ops whose scope
# carries none land in "unattributed" (a replayed graph's kernels carry
# only the entry's own annotation)
PHASE_MARKERS = ("coarse_select", "scan", "merge")
UNATTRIBUTED = "unattributed"

# the trace categories of device work, and of the annotations
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CPU_ANNOTATION = "user_annotation"
_GPU_ANNOTATION = "gpu_user_annotation"
_RUNTIME = ("cuda_runtime", "cuda_driver")
# the executor's entry names (the correlation key)
MODULE_PREFIX = "rt_"
# the xplane stats that carry an op's framework path, in order of
# preference
_SCOPE_KEYS = ("tf_op", "long_name", "op_name", "scope")
# the top-level key of a trace file that holds the timed calls
CALLS_KEY = "raftTimedCalls"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """One measured device-op execution from a profiler capture.

    ``device`` is the GPU track's name; ``module`` the executor entry
    (``rt_<family>_<digest>``) whose call launched it, else ``""``;
    ``scope`` the annotation path, else ``""``. Times are seconds in the
    capture's own clock domain."""

    device: str
    module: str
    op: str
    scope: str
    start_s: float
    dur_s: float

    @property
    def phase(self) -> str:
        """The first :data:`PHASE_MARKERS` entry that is a component of
        ``scope``, else :data:`UNATTRIBUTED`."""
        if self.scope:
            parts = self.scope.split("/")
            for marker in PHASE_MARKERS:
                if marker in parts:
                    return marker
        return UNATTRIBUTED


# ---------------------------------------------------------------------------
# capture: the profiler session and the timed-call window
# ---------------------------------------------------------------------------


class CaptureWindow:
    """The calls timed while one window was open: ``(module, start event,
    end event, host time)``."""

    def __init__(self):
        self.calls: list = []

    def timings(self) -> List[dict]:
        """``[{"module", "start_s", "dur_s"}]``: each timed call's device
        seconds between its events (waits for the last event), with the
        host time it was enqueued at."""
        out = []
        for module, ev0, ev1, t in self.calls:
            ev1.synchronize()
            out.append({"module": module, "start_s": t,
                        "dur_s": ev0.elapsed_time(ev1) * 1e-3})
        return out


_windows: List[CaptureWindow] = []  # guarded-by: _windows_lock
_windows_lock = threading.Lock()


def window_open() -> bool:
    """Whether any capture window is open (a racy read: a call that
    starts as a window opens may go untimed)."""
    return bool(_windows)  # graftlint: disable=R8(racy read by design: a call that starts as a window opens may go untimed)


def note_call(module: str, ev0, ev1) -> None:
    """Record one timed call into every open window."""
    t = time.perf_counter()
    with _windows_lock:
        for w in _windows:
            w.calls.append((module, ev0, ev1, t))


@contextlib.contextmanager
def capture_window():
    """Open a capture window for the enclosed block: the executor times
    every CUDA call while it is open. Yields the :class:`CaptureWindow`."""
    w = CaptureWindow()
    with _windows_lock:
        _windows.append(w)
    try:
        yield w
    finally:
        with _windows_lock:
            _windows.remove(w)


# A CUDA graph captured while a profiler session ran hung the process on
# the card, so graph captures and sessions exclude each other: a session
# waits for the captures under way, and a capture meets a running session
# with :class:`SessionRunning` (its caller releases its locks, waits in
# :func:`wait_for_session` and tries again; a capture that waited here
# with the executor's lock held would deadlock a session whose block
# searches).
_gate = threading.Condition()
_session_thread: Optional[int] = None  # guarded-by: _gate
_captures = 0  # guarded-by: _gate


class SessionRunning(RuntimeError):
    """A profiler session runs on another thread, so a CUDA graph
    capture must wait for it to end (:func:`wait_for_session`)."""


@contextlib.contextmanager
def graph_capture():
    """Held around a CUDA graph capture: no session starts until it
    ends. Raises :class:`SessionRunning` while a session runs on another
    thread, and ``RuntimeError`` on the thread that runs one (waiting
    there would never end)."""
    global _captures
    with _gate:
        if _session_thread == threading.get_ident():
            raise RuntimeError(
                "a CUDA graph cannot be captured inside a profiler session "
                "on the same thread: warm the executor before the session")
        if _session_thread is not None:
            raise SessionRunning("a profiler session is running")
        _captures += 1
    try:
        yield
    finally:
        with _gate:
            _captures -= 1
            _gate.notify_all()


def wait_for_session() -> None:
    """Return once no profiler session is running."""
    with _gate:
        _gate.wait_for(lambda: _session_thread is None)


@contextlib.contextmanager
def _profiler_turn(wait: bool):
    """The profiler for the enclosed block, once the graph captures under
    way have ended. Another session running raises, or with ``wait``
    is waited for."""
    global _session_thread
    with _gate:
        if _session_thread is not None and not wait:
            raise RuntimeError("a profiler session is already running")
        _gate.wait_for(lambda: _session_thread is None and _captures == 0)
        _session_thread = threading.get_ident()
    try:
        yield
    finally:
        with _gate:
            _session_thread = None
            _gate.notify_all()


# torch.profiler's stop deadlocked on the card with a CUDA graph replay
# that another thread launched at that moment (the stopping thread in
# the profiler's teardown, the other in the graph launch), so the
# executor's dispatches and the profiler's start and stop exclude each
# other: a dispatch enqueues its work inside :func:`launching`, and
# :func:`_quiesced` waits for those under way and holds new ones back
# while the profiler turns on or off. A session's body runs unhindered.
_launch_gate = threading.Condition()
_launches = 0  # guarded-by: _launch_gate
_toggling = False  # guarded-by: _launch_gate


@contextlib.contextmanager
def launching():
    """Held around an executor dispatch's device work: it does not
    overlap the profiler turning on or off (:func:`_quiesced`)."""
    global _launches
    with _launch_gate:
        _launch_gate.wait_for(lambda: not _toggling)
        _launches += 1
    try:
        yield
    finally:
        with _launch_gate:
            _launches -= 1
            _launch_gate.notify_all()


@contextlib.contextmanager
def _quiesced():
    """No dispatch under way or starting in the enclosed block."""
    global _toggling
    with _launch_gate:
        _launch_gate.wait_for(lambda: not _toggling)
        _toggling = True
        _launch_gate.wait_for(lambda: _launches == 0)
    try:
        yield
    finally:
        with _launch_gate:
            _toggling = False
            _launch_gate.notify_all()


_primed = False  # guarded-by: _prime_lock
_prime_lock = threading.Lock()


def prime() -> None:
    """Initialise the profiler's CUDA activity tracing on the calling
    thread, once a process: an empty session. The profiler's CUDA side
    initialises on the thread of its first session and refuses another
    ("External init callback must run in same thread as registerClient",
    and no device event recorded), so a server that captures on request
    threads primes it from the thread that starts it
    (:meth:`~raft_tpu_torch.serving.exporter.MetricsExporter.start`). A
    no-op without a card."""
    global _primed
    with _prime_lock:
        if _primed or not torch.cuda.is_available():
            return
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with _profiler_turn(wait=True):
            with _quiesced():
                prof.start()
            with _quiesced():
                prof.stop()
        _primed = True


class Capture:
    """What a :func:`session` wrote: ``path``, None until it ends."""

    def __init__(self):
        self.path: Optional[str] = None


@contextlib.contextmanager
def session(profile_dir: str):
    """A ``torch.profiler`` session over the enclosed block, every
    thread's ranges recorded, with a capture window open; on exit the
    Chrome trace is exported into
    ``profile_dir`` with the window's timed calls under
    :data:`CALLS_KEY`. Yields a :class:`Capture`. Starts once the CUDA
    graph captures under way have ended, and keeps new ones waiting
    until it stops (:func:`graph_capture`); the profiler turns on and off
    between executor dispatches (:func:`launching`). Raises if another
    session is running (the profiler is process-wide)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    cap = Capture()
    # every thread's ranges: the executor's calls run on the serving
    # threads, not on the one that starts the session
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
    with _profiler_turn(wait=False), capture_window() as win:
        with _quiesced():
            prof.start()
        try:
            yield cap
        finally:
            with _quiesced():
                prof.stop()
            calls = win.timings()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{socket.gethostname()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data[CALLS_KEY] = calls
    with open(path, "w") as f:
        json.dump(data, f)
    cap.path = path


# ---------------------------------------------------------------------------
# trace files
# ---------------------------------------------------------------------------


def _is_chrome(path: str) -> bool:
    return path.endswith((".trace.json", ".trace.json.gz"))


def _is_xplane(path: str) -> bool:
    return path.endswith(".xplane.pb")


def trace_snapshot(profile_dir: str) -> Dict[str, float]:
    """``{path: mtime}`` of every ``*.trace.json[.gz]`` and
    ``*.xplane.pb`` in a capture directory (and the
    ``plugins/profile/<run>/`` nesting of other tools). A caller about to
    capture takes this snapshot and resolves the capture's own output
    with :func:`fresh_trace_file`, instead of trusting the newest file,
    which would be a previous capture's when this one wrote none. Mtimes
    matter: a rewritten file is fresh."""
    pats = (os.path.join(profile_dir, "plugins", "profile", "*",
                         "*.trace.json*"),
            os.path.join(profile_dir, "*.trace.json*"),
            os.path.join(profile_dir, "plugins", "profile", "*",
                         "*.xplane.pb"),
            os.path.join(profile_dir, "*.xplane.pb"))
    out: Dict[str, float] = {}
    for pat in pats:
        for p in glob.glob(pat):
            if _is_chrome(p) or _is_xplane(p):
                try:
                    out[p] = os.path.getmtime(p)
                except OSError:   # raced a cleanup: not a capture
                    pass
    return out


def _newest(paths, mtimes) -> str:
    """The newest chrome trace among ``paths`` when there is one, else
    the newest ``.xplane.pb``: the chrome trace stays primary."""
    pool = [p for p in paths if _is_chrome(p)] or list(paths)
    return max(pool, key=lambda p: (mtimes[p], p))


def fresh_trace_file(profile_dir: str,
                     before: Dict[str, float]) -> Optional[str]:
    """The trace file a just-finished capture produced: the newest path
    that is new, or rewritten, since the :func:`trace_snapshot`
    ``before`` (a chrome trace preferred to an ``.xplane.pb``); None when
    the capture wrote none."""
    now = trace_snapshot(profile_dir)
    fresh = [p for p, m in now.items() if before.get(p) != m]
    if not fresh:
        return None
    return _newest(fresh, now)


def latest_trace_file(profile_dir: str) -> Optional[str]:
    """The newest trace file under ``profile_dir`` (a chrome trace
    preferred; an ``.xplane.pb`` when the directory holds only that), or
    None."""
    found = trace_snapshot(profile_dir)
    if not found:
        return None
    return _newest(found, found)


def load_trace(source) -> dict:
    """A Chrome-trace JSON object from ``source``: a dict passes through;
    a ``.json``/``.json.gz`` path is read; a directory yields its newest
    chrome capture (``FileNotFoundError`` when it holds none). Chrome
    traces only: :func:`load_ops` also reads ``.xplane.pb``."""
    if isinstance(source, dict):
        return source
    path = os.fspath(source)
    if os.path.isdir(path):
        found = {p: m for p, m in trace_snapshot(path).items()
                 if _is_chrome(p)}
        if not found:
            raise FileNotFoundError(
                f"no *.trace.json[.gz] capture under {path!r} "
                "(for .xplane.pb captures use load_ops)")
        path = _newest(found, found)
    if _is_xplane(path):
        raise ValueError(
            f"{path!r} is an xplane protobuf, not a chrome trace — use "
            "load_ops/parse_xplane")
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def _enclosing(ranges: dict, queries: dict) -> Dict[int, List[str]]:
    """``{query id: [names, outermost first]}`` of the ranges
    ``[start, end)`` enclosing each query time on the same key.
    ``ranges`` maps a key to ``[(start, end, name)]`` (nested per key, as
    one thread's ``record_function`` ranges are); ``queries`` a key to
    ``[(t, id)]``. One sweep a key."""
    out: Dict[int, List[str]] = {}
    for key, qs in queries.items():
        rs = sorted(ranges.get(key, ()), key=lambda r: (r[0], -r[1]))
        stack: list = []
        j = 0
        for t, qid in sorted(qs):
            while j < len(rs) and rs[j][0] <= t:
                while stack and stack[-1][1] <= rs[j][0]:
                    stack.pop()
                stack.append(rs[j])
                j += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out[qid] = [r[2] for r in stack if r[0] <= t < r[1]]
    return out


def parse_chrome_trace(data: dict) -> List[DeviceOp]:
    """The device ops of one ``torch.profiler`` Chrome trace (see the
    module docstring for how each op's device, module and scope are
    read). Timestamps convert from microseconds to seconds."""
    procs: Dict = {}
    events = data.get("traceEvents", [])
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            procs[ev.get("pid")] = (ev.get("args") or {}).get("name", "")
    launches: Dict = {}
    cpu_ranges: Dict = collections.defaultdict(list)
    gpu_ranges: Dict = collections.defaultdict(list)
    dev_events = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts = float(ev.get("ts", 0.0))
        end = ts + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATEGORIES:
            dev_events.append(ev)
        elif cat in _RUNTIME and "correlation" in args:
            launches[args["correlation"]] = ((ev.get("pid"), ev.get("tid")),
                                             ts)
        elif cat == _CPU_ANNOTATION:
            cpu_ranges[(ev.get("pid"), ev.get("tid"))].append(
                (ts, end, str(ev.get("name", ""))))
        elif cat == _GPU_ANNOTATION:
            gpu_ranges[ev.get("pid")].append(
                (ts, end, str(ev.get("name", ""))))
    cpu_q: Dict = collections.defaultdict(list)
    gpu_q: Dict = collections.defaultdict(list)
    for n, ev in enumerate(dev_events):
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        if launch is not None:
            cpu_q[launch[0]].append((launch[1], n))
        gpu_q[ev.get("pid")].append((float(ev.get("ts", 0.0)), n))
    on_cpu = _enclosing(cpu_ranges, cpu_q)
    on_gpu = _enclosing(gpu_ranges, gpu_q)
    out: List[DeviceOp] = []
    for n, ev in enumerate(dev_events):
        names = on_cpu.get(n) or on_gpu.get(n) or []
        modules = [m for m in names if m.startswith(MODULE_PREFIX)]
        pid = ev.get("pid")
        args = ev.get("args") or {}
        device = procs.get(pid) or (f"GPU {args['device']}"
                                    if "device" in args else f"pid:{pid}")
        out.append(DeviceOp(
            device=device, module=modules[-1] if modules else "",
            op=str(ev.get("name", "")), scope="/".join(names),
            start_s=float(ev.get("ts", 0.0)) * 1e-6,
            dur_s=float(ev.get("dur", 0.0)) * 1e-6))
    return out


def parse_xplane(source) -> List[DeviceOp]:
    """The device ops of one serialized XSpace (``.xplane.pb`` path or
    raw bytes), read by the stdlib decoder :mod:`raft_tpu_torch.core.
    xplane`, as the JAX package reads them: a device op is an event whose
    resolved stats carry ``hlo_module`` (module-less host events are
    skipped), its device the plane's name, its scope the first framework
    path stat present, times in seconds (the line's ``timestamp_ns`` plus
    the event's ``offset_ps``)."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(os.fspath(source), "rb") as f:
            data = f.read()
    space = xplane.parse_xspace(data)
    out: List[DeviceOp] = []
    for plane in space["planes"]:
        device = plane["name"]
        for line in plane["lines"]:
            t0 = float(line["timestamp_ns"]) * 1e-9
            for ev in line["events"]:
                stats = xplane.resolve_stats(ev, plane["stat_metadata"])
                module = stats.get("hlo_module")
                if not module or not isinstance(module, str):
                    continue
                scope = ""
                for key in _SCOPE_KEYS:
                    v = stats.get(key)
                    if v and isinstance(v, str):
                        scope = v
                        break
                out.append(DeviceOp(
                    device=device, module=module,
                    op=plane["event_metadata"].get(
                        ev["metadata_id"], str(ev["metadata_id"])),
                    scope=scope,
                    start_s=t0 + float(ev["offset_ps"]) * 1e-12,
                    dur_s=float(ev["duration_ps"]) * 1e-12))
    return out


def parse_calls(data: dict) -> List[dict]:
    """The timed calls a :func:`session` stored in its trace."""
    return list(data.get(CALLS_KEY, ()))


def load_ops(source) -> Tuple[List[DeviceOp], Optional[str]]:
    """``(device ops, trace file)`` from a parsed chrome dict (the file
    is then None), a ``.trace.json[.gz]`` or ``.xplane.pb`` path, or a
    capture directory (its newest capture: the chrome trace when it
    holds one, else its ``.xplane.pb``)."""
    ops, _, path = _load(source)
    return ops, path


def _load(source):
    path = None
    if not isinstance(source, dict):
        path = os.fspath(source)
        if os.path.isdir(path):
            found = latest_trace_file(path)
            if found is None:
                raise FileNotFoundError(
                    f"no *.trace.json[.gz] / *.xplane.pb capture under "
                    f"{path!r}")
            path = found
        if _is_xplane(path):
            # an xplane carries no timed calls
            return parse_xplane(path), [], path
    data = load_trace(source if path is None else path)
    return parse_chrome_trace(data), parse_calls(data), path


@dataclasses.dataclass
class InvocationWindow:
    """One dispatch's worth of a module's capture events:
    the ops between two idle gaps the gap-clustering called dispatch
    boundaries. ``shard_seconds`` is per-device busy time WITHIN the
    window, so :attr:`skew` is the straggler skew of this one dispatch
    — the per-dispatch sample the ``serving.mesh.shard_skew_p99``
    distribution is built from."""

    start_s: float
    end_s: float
    ops: int
    device_seconds: float
    phase_seconds: Dict[str, float]
    shard_seconds: Dict[str, float]

    @property
    def skew(self) -> float:
        """max − min per-device busy seconds (0.0 single-device)."""
        if len(self.shard_seconds) < 2:
            return 0.0
        vals = self.shard_seconds.values()
        return max(vals) - min(vals)

    def to_dict(self) -> dict:
        return {"start_s": self.start_s, "end_s": self.end_s,
                "ops": self.ops, "device_seconds": self.device_seconds,
                "phase_seconds": dict(self.phase_seconds),
                "shard_seconds": dict(self.shard_seconds),
                "skew": self.skew}


# auto gap-clustering knob: a gap joins the dispatch boundaries when
# it is at least this fraction of the smallest gap the op-count floor
# already forced to be a boundary — catches the dispatches the
# MIN-count heuristic undercounts (conditional top-level ops) without
# promoting intra-dispatch idle (which sits well below real dispatch
# gaps) into fake boundaries
GAP_EXTEND_RATIO = 0.5


def invocation_windows(ops: Iterable[DeviceOp], *,
                       gap_s: Optional[float] = None,
                       extend_ratio: float = GAP_EXTEND_RATIO
                       ) -> List[InvocationWindow]:
    """Split ONE module's capture events into per-dispatch invocation
    windows by gap-clustering the merged (all-device) timeline.

    Candidate boundaries are the positive idle gaps — instants where
    every device of the module went quiet before the next op started
    (overlapping devices merge: a mesh dispatch runs its shards
    concurrently, so intra-dispatch "gaps" on one device are covered
    by the other's ops). Which candidates become boundaries:

    - With an explicit ``gap_s``: every gap above it.
    - Auto (default): the op-count bounds anchor the clustering — a
      top-level unconditional op runs exactly once per dispatch, so
      the MIN positive per-(device, op) event count ``n_min`` is a
      FLOOR on invocations and the MAX count ``n_max`` (loop-body ops
      repeat per iteration) a CEILING. The largest ``n_min − 1`` gaps
      are definite boundaries; remaining gaps within
      ``extend_ratio`` of the smallest definite one also split
      (dispatches the MIN heuristic undercounted because its op was
      conditional).

    Either way at most ``n_max − 1`` boundaries are kept, so windows
    can never exceed the loop-iteration ceiling. Pure function of its
    inputs — fixture-pinned, deterministic (ties break by event
    order). An empty op list yields no windows; back-to-back
    dispatches with NO idle gap merge into one window (the caller's
    invocation count falls back to the ``n_min`` floor — see
    :func:`correlate`)."""
    mops = sorted(ops, key=lambda o: (o.start_s, o.dur_s, o.device))
    if not mops:
        return []
    counts: Dict[tuple, int] = collections.defaultdict(int)
    for op in mops:
        counts[(op.device, op.op)] += 1
    n_min = min(counts.values())
    n_max = max(counts.values())
    gaps: List[Tuple[float, int]] = []
    max_end = mops[0].start_s + mops[0].dur_s
    for i, op in enumerate(mops[1:], start=1):
        g = op.start_s - max_end
        if g > 0:
            gaps.append((g, i))
        max_end = max(max_end, op.start_s + op.dur_s)
    by_size = sorted(gaps, key=lambda gi: (-gi[0], gi[1]))
    if gap_s is not None:
        chosen = [(g, i) for g, i in by_size if g > gap_s]
    else:
        definite = by_size[:max(n_min - 1, 0)]
        chosen = list(definite)
        if definite:
            thresh = definite[-1][0] * extend_ratio
            chosen += [(g, i) for g, i in by_size[len(definite):]
                       if g >= thresh]
    chosen = chosen[:max(n_max - 1, 0)]
    cuts = sorted(i for _, i in chosen)
    windows: List[InvocationWindow] = []
    lo = 0
    for cut in cuts + [len(mops)]:
        chunk = mops[lo:cut]
        lo = cut
        if not chunk:
            continue
        phase: Dict[str, float] = collections.defaultdict(float)
        shard: Dict[str, float] = collections.defaultdict(float)
        for op in chunk:
            phase[op.phase] += op.dur_s
            shard[op.device] += op.dur_s
        windows.append(InvocationWindow(
            start_s=min(o.start_s for o in chunk),
            end_s=max(o.start_s + o.dur_s for o in chunk),
            ops=len(chunk),
            device_seconds=sum(o.dur_s for o in chunk),
            phase_seconds=dict(phase),
            shard_seconds=dict(shard),
        ))
    return windows


@dataclasses.dataclass
class ModuleAttribution:
    """Measured device truth for ONE resident executor entry.

    ``device_seconds`` is the entry's measured device time (its timed
    calls' event time where the window timed any, else the summed
    durations of its trace ops) and ``invocations`` its executions in
    the window (the timed calls, else the gap-clustered windows floored
    by the least positive per-(device, op) count). ``phase_seconds``,
    ``shard_seconds``, ``kernel_seconds`` and ``windows`` are the trace's
    breakdown of the ops it saw (``trace_seconds`` in all).
    ``modeled_bytes_per_call``/``flops`` come from the entry's cost
    model, so measured achieved GB/s is ``bytes x invocations /
    device_seconds``."""

    digest: str
    module: str
    family: str
    device_seconds: float
    invocations: int
    phase_seconds: Dict[str, float]
    shard_seconds: Dict[str, float]
    window: Tuple[float, float]
    modeled_bytes_per_call: float = 0.0
    modeled_flops_per_call: float = 0.0
    payload_model: Optional[dict] = None
    windows: List[InvocationWindow] = dataclasses.field(
        default_factory=list)
    timed_calls: int = 0
    trace_seconds: float = 0.0
    kernel_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def skew_samples(self) -> List[float]:
        """One straggler-skew sample per invocation window that ran on
        several devices."""
        return [w.skew for w in self.windows
                if len(w.shard_seconds) > 1]

    @property
    def mesh(self) -> bool:
        """Whether this entry is a mesh plan."""
        return (self.payload_model is not None
                or self.family.startswith("dist_"))

    def measured_gbps(self) -> float:
        if self.device_seconds <= 0:
            return 0.0
        return (self.modeled_bytes_per_call * self.invocations
                / self.device_seconds / 1e9)

    def measured_gflops(self) -> float:
        if self.device_seconds <= 0:
            return 0.0
        return (self.modeled_flops_per_call * self.invocations
                / self.device_seconds / 1e9)

    def to_dict(self) -> dict:
        return {
            "digest": self.digest,
            "module": self.module,
            "family": self.family,
            "device_seconds": self.device_seconds,
            "invocations": self.invocations,
            "phase_seconds": dict(self.phase_seconds),
            "shard_seconds": dict(self.shard_seconds),
            "window": list(self.window),
            "modeled_bytes_per_call": self.modeled_bytes_per_call,
            "modeled_flops_per_call": self.modeled_flops_per_call,
            "measured_gbps": self.measured_gbps(),
            "measured_gflops": self.measured_gflops(),
            "mesh": self.mesh,
            "invocation_windows": [w.to_dict() for w in self.windows],
            "timed_calls": self.timed_calls,
            "trace_seconds": self.trace_seconds,
            "kernel_seconds": dict(self.kernel_seconds),
        }


@dataclasses.dataclass
class Attribution:
    """One capture's correlation: per-entry measured device truth plus
    the op seconds that matched no resident entry (``""``: ops no entry's
    annotation enclosed)."""

    modules: Dict[str, ModuleAttribution]
    unmatched_modules: Dict[str, float]
    trace_file: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "modules": {d: m.to_dict() for d, m in self.modules.items()},
            "unmatched_modules": dict(self.unmatched_modules),
            "trace_file": self.trace_file,
        }


def correlate(ops: Iterable[DeviceOp], costs: dict,
              calls: Optional[Iterable[dict]] = None) -> Attribution:
    """Correlate parsed device ops, and the timed calls of the capture
    window (``[{"module", "start_s", "dur_s"}]``), back to executor
    entries. ``costs`` is ``SearchExecutor.executable_costs()``, whose
    ``hlo_module`` names each entry's annotation. Without ``calls`` this
    is the JAX package's ``correlate`` (``profiling.py:574``); an entry
    with timed calls takes its device seconds and invocations from them
    and the rest from the trace (see :class:`ModuleAttribution`). Pure
    function of its inputs."""
    modmap = {}
    for digest, info in costs.items():
        name = info.get("hlo_module")
        if name:
            modmap[name] = digest
    by_module: Dict[str, List[DeviceOp]] = collections.defaultdict(list)
    unmatched: Dict[str, float] = collections.defaultdict(float)
    for op in ops:
        if op.module in modmap:
            by_module[op.module].append(op)
        else:
            unmatched[op.module] += op.dur_s
    timed: Dict[str, List[dict]] = collections.defaultdict(list)
    for c in calls or ():
        if c["module"] in modmap:
            timed[c["module"]].append(c)
    out: Dict[str, ModuleAttribution] = {}
    for module in list(by_module) + [m for m in timed
                                     if m not in by_module]:
        mops = by_module.get(module, [])
        digest = modmap[module]
        info = costs[digest]
        phase: Dict[str, float] = collections.defaultdict(float)
        shard: Dict[str, float] = collections.defaultdict(float)
        kern: Dict[str, float] = collections.defaultdict(float)
        op_counts: Dict[tuple, int] = collections.defaultdict(int)
        total = 0.0
        for op in mops:
            total += op.dur_s
            phase[op.phase] += op.dur_s
            shard[op.device] += op.dur_s
            kern[op.op] += op.dur_s
            op_counts[(op.device, op.op)] += 1
        windows = invocation_windows(mops)
        mc = timed.get(module, [])
        if mops:
            t0 = min(op.start_s for op in mops)
            t1 = max(op.start_s + op.dur_s for op in mops)
        else:
            t0 = min(c["start_s"] for c in mc)
            t1 = max(c["start_s"] + c["dur_s"] for c in mc)
        if mc:
            device_seconds = sum(float(c["dur_s"]) for c in mc)
            invocations = len(mc)
        else:
            device_seconds = total
            # the gap-clustered windows, floored by the least per-(device,
            # op) count: loop-body ops repeat per iteration, and
            # back-to-back dispatches with no idle gap merge into one
            # window
            invocations = max(len(windows), min(op_counts.values()))
        out[digest] = ModuleAttribution(
            digest=digest, module=module,
            family=str(info.get("family", "")),
            device_seconds=device_seconds,
            invocations=invocations,
            phase_seconds=dict(phase),
            shard_seconds=dict(shard),
            window=(t0, t1),
            modeled_bytes_per_call=float(info.get("bytes_accessed", 0.0)),
            modeled_flops_per_call=float(info.get("flops", 0.0)),
            payload_model=info.get("collective_payload"),
            windows=windows,
            timed_calls=len(mc),
            trace_seconds=total,
            kernel_seconds=dict(kern),
        )
    return Attribution(modules=out, unmatched_modules=dict(unmatched))


def attribute(source, costs: dict) -> Attribution:
    """Load, parse and correlate one capture: ``source`` is anything
    :func:`load_trace` takes, ``costs`` the executor's
    ``executable_costs()``. The timed calls stored in the trace take part
    (:func:`correlate`). Bumps ``profiling.captures`` /
    ``profiling.device_ops``."""
    ops, calls, trace_file = _load(source)
    attr = correlate(ops, costs, calls)
    attr.trace_file = trace_file
    tracing.inc_counters({CAPTURES: 1.0, DEVICE_OPS: float(len(ops))})
    return attr


def _emit_measured_mesh(att: ModuleAttribution) -> None:
    """Re-emit one mesh executable's phase + shard spans from measured
    device time — the ``modeled: False`` counterpart of the modeled
    spans ``mesh_trace`` records per dispatch.

    Phase spans lay out sequentially from the capture window's start,
    each covering its mean per-invocation measured duration (attrs
    carry the totals); the modeled wire bytes ride along from the
    entry's payload model so Perfetto shows bytes over MEASURED time.
    Shard spans and the straggler gauges
    (``serving.mesh.{shard_skew,slowest_shard}``) recompute from mean
    per-invocation per-device busy seconds — superseding the
    host-side readiness poll's numbers."""
    inv = max(att.invocations, 1)
    t = att.window[0]
    phase_bytes = {}
    if att.payload_model:
        phase_bytes = {
            "coarse_select": att.payload_model.get("coarse_bytes", 0),
            "scan": 0,
            "merge": att.payload_model.get("merge_bytes", 0),
        }
    for marker in PHASE_MARKERS + (UNATTRIBUTED,):
        secs = att.phase_seconds.get(marker, 0.0)
        if secs <= 0.0:
            continue
        mean = secs / inv
        attrs = {"modeled": False, "source": "profiler",
                 "family": att.family, "digest": att.digest,
                 "device_seconds": secs, "invocations": att.invocations}
        if marker in phase_bytes:
            attrs["wire_bytes"] = phase_bytes[marker]
        tracing.record_span(f"serving.mesh.{marker}", t, t + mean,
                            attrs=attrs)
        t += mean
    if att.shard_seconds:
        timings = [att.shard_seconds[d] / inv
                   for d in sorted(att.shard_seconds)]
        tracing.record_mesh_spans(
            att.family, att.window[0],
            att.window[0] + max(timings),
            shard_timings=timings,
            shard_attrs={"modeled": False, "source": "profiler",
                         "digest": att.digest},
            # per-dispatch skew distribution one sample per
            # invocation window -> serving.mesh.shard_skew_p50/_p99
            skew_samples=att.skew_samples(),
            count_dispatch=False)


def publish(attr: Attribution) -> dict:
    """Publish one attribution into the live registries — the
    "measured supersedes modeled".

    Per executable: ``serving.executable.<digest>.measured_*`` gauges
    (device seconds, invocations, achieved GB/s / GFLOP/s from
    modeled-bytes-over-measured-time — rendered as the labeled
    ``serving_executable_measured_*{digest=...}`` Prometheus
    families); mesh executables additionally re-emit their phase and
    shard spans with ``modeled: False`` (see
    :func:`_emit_measured_mesh`) — recomputing the straggler gauges
    from device timings. Process totals land in the
    ``serving.attribution.*`` counters ``serving.metrics.derived()``
    divides for the measured achieved-bandwidth columns. Returns
    ``{digest: measured-stats}``."""
    out = {}
    totals = {ATTRIBUTED_SECONDS: 0.0, ATTRIBUTED_BYTES: 0.0,
              ATTRIBUTED_FLOPS: 0.0}
    for digest, att in attr.modules.items():
        base = f"serving.executable.{digest}."
        stats = {
            "device_seconds": att.device_seconds,
            "invocations": att.invocations,
            "gbps": att.measured_gbps(),
            "gflops": att.measured_gflops(),
        }
        tracing.set_gauges({
            base + "measured_device_seconds": att.device_seconds,
            base + "measured_invocations": float(att.invocations),
            base + "measured_gbps": stats["gbps"],
            base + "measured_gflops": stats["gflops"],
        })
        totals[ATTRIBUTED_SECONDS] += att.device_seconds
        totals[ATTRIBUTED_BYTES] += (att.modeled_bytes_per_call
                                     * att.invocations)
        totals[ATTRIBUTED_FLOPS] += (att.modeled_flops_per_call
                                     * att.invocations)
        if att.mesh:
            _emit_measured_mesh(att)
        out[digest] = stats
    if attr.modules:
        tracing.inc_counters(totals)
    return out


class RollingAttribution:
    """EWMA-folded steady-state device truth (the continuous scheduler's state).

    Incident captures publish a point-in-time snapshot;
    the continuous low-duty-cycle scheduler
    (:class:`~raft_tpu_torch.serving.continuous.ContinuousCapture`) instead
    folds every periodic capture window into THIS rolling state, so
    ``serving.attribution.rolling.*`` always carries a
    continuously-fresh measured number next to the wall-clock-derived
    one in ``serving.metrics.derived()`` — not the last incident's
    snapshot.

    Fold semantics (pinned by scripted tests): per capture window the
    totals (device seconds, modeled bytes/flops over all attributed
    executables), per-phase seconds, per-executable device seconds /
    bytes / flops, and the window's per-dispatch skew p99 each fold as
    ``ewma = alpha * x + (1 - alpha) * ewma`` (first fold seeds the
    state). Achieved GB/s is the RATIO of the byte and second EWMAs —
    stabler than an EWMA of ratios, and exactly the roofline
    accounting re-done on smoothed inputs. An executable ABSENT from a
    window holds its last value: a 100 ms capture simply may not have
    overlapped that program's traffic, which is no evidence it
    changed. Thread-safe; pure host-side dict work.

    Published gauges: ``serving.attribution.rolling.{windows,
    device_seconds,modeled_bytes,modeled_flops,gbps,gflops,
    shard_skew_p99}`` + ``.phase.<phase>_seconds``, and per
    executable the labeled ``serving.executable.<digest>
    .rolling_{gbps,device_seconds}`` family. The
    ``profiling.rolling.folds`` lifetime counter is the CI snapshot
    floor's evidence the pipeline stayed alive."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._phases: Dict[str, float] = {}
        self._execs: Dict[str, Dict[str, float]] = {}
        self._skew_p99: Optional[float] = None
        self.windows = 0

    def _ewma(self, store: dict, key: str, x: float) -> float:
        prev = store.get(key)
        store[key] = (x if prev is None
                      else self.alpha * x + (1.0 - self.alpha) * prev)
        return store[key]

    def fold(self, attr: Attribution) -> Optional[dict]:
        """Fold one capture window's attribution; returns the rolling
        snapshot (None for a window that attributed nothing — an empty
        capture is not evidence of zero throughput)."""
        if not attr.modules:
            return None
        win_secs = sum(m.device_seconds for m in attr.modules.values())
        win_bytes = sum(m.modeled_bytes_per_call * m.invocations
                        for m in attr.modules.values())
        win_flops = sum(m.modeled_flops_per_call * m.invocations
                        for m in attr.modules.values())
        phases: Dict[str, float] = collections.defaultdict(float)
        skews: List[float] = []
        for m in attr.modules.values():
            for ph, s in m.phase_seconds.items():
                phases[ph] += s
            skews.extend(m.skew_samples())
        with self._lock:
            self.windows += 1
            self._ewma(self._totals, "device_seconds", win_secs)
            self._ewma(self._totals, "modeled_bytes", win_bytes)
            self._ewma(self._totals, "modeled_flops", win_flops)
            for ph, s in phases.items():
                self._ewma(self._phases, ph, s)
            if skews:
                x = tracing.sample_quantile(skews, 0.99)
                self._skew_p99 = (
                    x if self._skew_p99 is None
                    else self.alpha * x
                    + (1.0 - self.alpha) * self._skew_p99)
            for digest, m in attr.modules.items():
                ex = self._execs.setdefault(digest, {})
                self._ewma(ex, "device_seconds", m.device_seconds)
                self._ewma(ex, "modeled_bytes",
                           m.modeled_bytes_per_call * m.invocations)
                self._ewma(ex, "modeled_flops",
                           m.modeled_flops_per_call * m.invocations)
                self._ewma(ex, "invocations", float(m.invocations))
            snap = self._snapshot_locked()
        tracing.inc_counter(ROLLING_FOLDS)
        self._publish(snap)
        return snap

    @staticmethod
    def _rate(num: float, secs: float) -> float:
        return num / secs / 1e9 if secs > 0 else 0.0

    def _snapshot_locked(self) -> dict:
        t = self._totals
        out = {
            "windows": self.windows,
            "device_seconds": t.get("device_seconds", 0.0),
            "modeled_bytes": t.get("modeled_bytes", 0.0),
            "modeled_flops": t.get("modeled_flops", 0.0),
            "gbps": self._rate(t.get("modeled_bytes", 0.0),
                               t.get("device_seconds", 0.0)),
            "gflops": self._rate(t.get("modeled_flops", 0.0),
                                 t.get("device_seconds", 0.0)),
            "phase_seconds": dict(self._phases),
            "shard_skew_p99": self._skew_p99 or 0.0,
            "executables": {},
        }
        for digest, ex in self._execs.items():
            out["executables"][digest] = {
                "device_seconds": ex.get("device_seconds", 0.0),
                "invocations": ex.get("invocations", 0.0),
                "gbps": self._rate(ex.get("modeled_bytes", 0.0),
                                   ex.get("device_seconds", 0.0)),
                "gflops": self._rate(ex.get("modeled_flops", 0.0),
                                     ex.get("device_seconds", 0.0)),
            }
        return out

    def snapshot(self) -> dict:
        """The current rolling state (the gauges' source of truth)."""
        with self._lock:
            return self._snapshot_locked()

    def _publish(self, snap: dict) -> None:
        p = ROLLING_PREFIX
        vals = {
            p + "windows": float(snap["windows"]),
            p + "device_seconds": snap["device_seconds"],
            p + "modeled_bytes": snap["modeled_bytes"],
            p + "modeled_flops": snap["modeled_flops"],
            p + "gbps": snap["gbps"],
            p + "gflops": snap["gflops"],
            p + "shard_skew_p99": snap["shard_skew_p99"],
        }
        for ph, s in snap["phase_seconds"].items():
            vals[f"{p}phase.{ph}_seconds"] = s
        for digest, ex in snap["executables"].items():
            base = f"serving.executable.{digest}."
            vals[base + "rolling_gbps"] = ex["gbps"]
            vals[base + "rolling_device_seconds"] = ex["device_seconds"]
        tracing.set_gauges(vals)

    def publish(self) -> dict:
        """Re-publish the rolling gauges from the held state (scrape
        refresh after a ``metrics.reset()``) and return the snapshot."""
        snap = self.snapshot()
        if snap["windows"]:
            self._publish(snap)
        return snap
