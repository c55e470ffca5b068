"""The traced stretch: a ``torch.profiler`` capture of part of the window,
read into device operations, their launching threads and the search
phases the host was in.

``torch.profiler`` records the CPU side only on the thread that starts
it, while the searches run on the sidecar's connection threads. So the
kernels and the runtime calls that launched them come from the card's
own trace (CUPTI records every thread), and the search phases from the
recording sink the sidecar reports to (``Recorder``), on the host's
clock. Two marks, ``searchbench_mark`` ranges entered on the profiling
thread at known host times, map one clock onto the other. The trace
names a launching thread by an id of its own: while the capture runs,
the sink makes two runtime calls (``THREAD_MARKS``) on each thread at
its first few phase boundaries there and notes when, and the trace
thread whose calls most of its marks meet is that thread
(``Stretch.threads``). A kernel is put in a phase only through its own
thread's mapping; where a thread in a phase could not be mapped, the
readers of phases read nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Tuple

from namazu_tpu_torch.obs import Telemetry

MARK = "searchbench_mark"
#: the runtime calls that name a thread in the trace
THREAD_MARKS = ("cudaEventRecord", "cudaStreamQuery")
#: the marks a thread makes in one capture
MARKS_PER_THREAD = 8
#: how far a thread mark's call may lie outside its host stamps (s)
THREAD_MARK_SLACK_S = 5e-4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: name fragments of B1, the pair-distance kernel (min_sq_kernel<2>)
B1_NAMES = ("min_sq_kernel<2>", "min_sq_kernelILi2E")


def thread_ids() -> Tuple[int, int]:
    """The ids a trace may give the calling thread: its native id (the
    profiling thread's) and its ``pthread_t`` in 32 bits (the card's
    runtime calls from other threads)."""
    return threading.get_native_id(), threading.get_ident() & 0xFFFFFFFF


class Recorder(Telemetry):
    """A telemetry sink that keeps each search phase's span: ``(thread
    ids, phase, start, end)`` in ``time.perf_counter`` seconds; while
    ``capturing``, each thread's marks: ``(thread ids, start, end)`` of
    the ``THREAD_MARKS`` calls at its first phase boundaries."""

    def __init__(self):
        self.spans: List[Tuple[Tuple[int, int], str, float, float]] = []
        self.marks: List[Tuple[Tuple[int, int], float, float]] = []
        self.capturing = False
        self._lock = threading.Lock()

    def _mark(self) -> None:
        ids = thread_ids()
        with self._lock:
            if not self.capturing or sum(
                    m[0] == ids for m in self.marks) >= MARKS_PER_THREAD:
                return
        import torch

        t0 = time.perf_counter()
        torch.cuda.Event().record()
        torch.cuda.current_stream().query()
        mark = (ids, t0, time.perf_counter())
        with self._lock:
            self.marks.append(mark)

    @contextlib.contextmanager
    def search_phase(self, phase: str):
        self._mark()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            span = (thread_ids(), phase, t0, time.perf_counter())
            with self._lock:
                self.spans.append(span)
            self._mark()


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start: float  # seconds on the host's clock
    end: float
    tid: Optional[int]  # the launching thread, where known
    launch: Optional[float]  # when it was launched, where known


class Stretch(NamedTuple):
    """What the traced stretch saw, on the host's clock."""

    start: float
    end: float
    ops: List[DeviceOp]
    spans: List[Tuple[Tuple[int, int], str, float, float]]
    #: the trace's id of each marked thread -> the recorder's ids
    threads: Dict[int, Tuple[int, int]]

    @property
    def seconds(self) -> float:
        return self.end - self.start


def capture(recorder: Recorder, seconds: float, path: str) -> Stretch:
    """Profile the process for ``seconds`` from now, write the card's
    trace to ``path`` and read it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    marks = []
    with recorder._lock:
        recorder.marks.clear()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            t = time.perf_counter()
            with torch.profiler.record_function(MARK):
                pass
            marks.append(t)
            if len(marks) == 1:
                recorder.capturing = True
                time.sleep(seconds)
                recorder.capturing = False
    prof.export_chrome_trace(path)
    return read(path, marks, recorder)


def map_threads(calls: List[Tuple[int, float]],
                marks: List[Tuple[Tuple[int, int], float, float]]
                ) -> Dict[int, Tuple[int, int]]:
    """``{trace thread id: recorder ids}`` from the trace's mark calls
    ``(thread id, host time)`` and the recorder's marks. A mark hits the
    threads whose calls lie inside its stamps (give or take
    ``THREAD_MARK_SLACK_S``); another thread's call may fall there too,
    so a recorder thread names the trace thread that most of its marks
    hit, where one does; a trace id that two recorder threads name maps
    to neither."""
    votes: Dict[Tuple[int, int], Counter] = {}
    for ids, t0, t1 in marks:
        hits = {tid for tid, t in calls
                if t0 - THREAD_MARK_SLACK_S <= t <= t1 + THREAD_MARK_SLACK_S}
        votes.setdefault(ids, Counter()).update(hits)
    named: Dict[int, set] = {}
    for ids, count in votes.items():
        top = count.most_common(2)
        if top and (len(top) == 1 or top[0][1] > top[1][1]):
            named.setdefault(top[0][0], set()).add(ids)
    return {tid: next(iter(ids)) for tid, ids in named.items()
            if len(ids) == 1}


def read(path: str, marks: List[float], recorder: Recorder) -> Stretch:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    stamps = sorted(e["ts"] for e in events
                    if e.get("name") == MARK
                    and e.get("cat") == "user_annotation")
    if len(stamps) != 2:
        raise RuntimeError(f"the trace holds {len(stamps)} marks, not 2")
    scale = (marks[1] - marks[0]) / ((stamps[1] - stamps[0]) * 1e-6)

    def host(ts: float) -> float:
        return marks[0] + (ts - stamps[0]) * 1e-6 * scale

    launcher = {e["args"]["correlation"]: (e["tid"], host(e["ts"]))
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        tid, launch = launcher.get(e.get("args", {}).get("correlation"),
                                   (None, None))
        ops.append(DeviceOp(e.get("name", ""), e["cat"], host(e["ts"]),
                            host(e["ts"] + e.get("dur", 0)), tid, launch))
    calls = [(e["tid"], host(e["ts"])) for e in events
             if e.get("cat") == "cuda_runtime"
             and e.get("name") in THREAD_MARKS]
    with recorder._lock:
        spans = [s for s in recorder.spans
                 if s[3] >= marks[0] and s[2] <= marks[1]]
        thread_marks = list(recorder.marks)
    return Stretch(marks[0], marks[1], ops, spans,
                   map_threads(calls, thread_marks))


def busy_seconds(stretch: Stretch) -> float:
    """Seconds of the stretch in which a device operation ran."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(o.start, stretch.start), min(o.end, stretch.end))
                       for o in stretch.ops):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def phase_index(stretch: Stretch, phase: str) -> Dict[tuple, list]:
    """``{recorder thread ids: sorted [(start, end)]}`` of one phase's
    spans."""
    out: Dict[tuple, list] = {}
    for ids, p, s, e in stretch.spans:
        if p == phase:
            out.setdefault(ids, []).append((s, e))
    for v in out.values():
        v.sort()
    return out


def _inside(t: float, spans: list) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def kernels_in(stretch: Stretch, phase: str) -> Optional[List[DeviceOp]]:
    """The kernels launched inside ``phase`` by the thread in it, each
    through its own thread's mapping. A phase's kernels are launched by
    the thread in the phase, so a launcher the trace could not map is
    another thread (autograd's, for the surrogate's training) as long as
    every thread with a span of the phase in the stretch is mapped; where
    one is not, or no kernel was found, None."""
    index = phase_index(stretch, phase)
    if set(index) - set(stretch.threads.values()):
        return None
    out = [op for op in stretch.ops
           if op.cat == "kernel" and op.launch is not None
           and op.tid in stretch.threads
           and _inside(op.launch, index.get(stretch.threads[op.tid], []))]
    return out or None


def is_b1(op: DeviceOp) -> bool:
    return op.cat == "kernel" and any(n in op.name for n in B1_NAMES)


def breakdown(stretch: Stretch, top: int = 10) -> dict:
    """The costliest device operations by name, and the longest idle
    gaps of the device, each named by the search phases the host was in
    (``unlabelled`` where none: ingest has no phase on this path)."""
    by_name: Dict[str, float] = {}
    for o in stretch.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, last = [], stretch.start
    for s, e in sorted((o.start, o.end) for o in stretch.ops):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if stretch.end > last:
        gaps.append((last, stretch.end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        phases = sorted({p for _, p, a, b in stretch.spans if a <= mid <= b})
        named.append(["+".join(phases) or "unlabelled", e - s])
    return {"device_ops": [[n[:120], t] for n, t in ops],
            "idle_gaps": named}
