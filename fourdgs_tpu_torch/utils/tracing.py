"""The port's tracer: spans at every layer boundary, device marks inside
the captured programs, host spans on the two hot calls, and the registry
of what the programs did.

**Spans.** `span(name)` bounds a layer (`render.splats`, `splats.hexplane`,
`raster.blend`, `train.adam`, ...). In an eager run it opens the
`record_function` range of its name, as the layers always did, so eager
profiles read as before. While the current stream is capturing a program
(`capturing`), it opens none: a range that launches kernels would enter
the profiler's device records, and a replay opens no range anyway.
Instead its entry and exit each launch a device mark into the graph.
`span.grads(*tensors)` passes a span's outputs through an identity whose
backward launches a mark too, on the stream autograd runs the backward
on (the forward's), so the backward's layers are bounded as well.

**Device marks.** A mark is one thread of `trace_stamp_kernel`
(csrc/trace.cu) writing the card's nanosecond timer into one column of
the current row of a device ring (`ROWS` replays of `COLS` marks, the ring
and its row counter allocated once per device, outside any capture, and
owned by the tracer: a program's rows outlive it). The capture's last
mark moves the counter on, so each replay of a traced program fills one
row. Each mark opens a segment: a span's entry its own, its exit the one
that was open at its entry, a backward mark `<span>/backward`. The time
from mark i to the next mark in time belongs to the segment mark i
opens, so a replay's segments sum to its first-to-last time exactly, in
whatever order autograd interleaves a batch's backwards. `MARKS`, read
when a capture begins, turns the marks off (for measuring what they
cost); eager runs launch none.

**Host spans.** `HostSpans(root)` times the consecutive phases of one
frame (`frame.camera_in`, `frame.key`, `frame.inputs`, `frame.launch`,
`frame.outputs`) or step (`step.bind`, `step.inputs`, `step.launch`,
`step.outputs`; `PHASES`) by `perf_counter_ns`: each `lap(now())` ends the
next phase (a capture falls in `frame.key` or `step.bind`). Each phase's
nanoseconds add to its counter (`host_totals`; the calls' times are summed
a batch at a time, so a call costs six clock reads and a few appends), and
while a profiler runs the phases are also kept under the replay's number,
the identifier the replay's device row has.

**Profiled replays.** Each replay's row is tagged on the host with its
program, its replay number and the profiler session it ran in (0 for
none: one read of the profiler's flag). The first traced call of a
session opens the `tracing.anchor` range, which launches nothing, at a
`perf_counter_ns` the tracer keeps, and keeps the `torch.profiler.profile`
that a caller holds in a local variable (the benchmark's traced window
and the tools hold theirs so). Nothing on the replay path waits on the
device.

**Reading.** `rows`, `segment_ms`, `device_ms` and `host_ms` read the last
session's replays. Once the session's profiler has stopped, its own
device records split each segment into the device's work and its idle:
each replay is put on the profiler's clock by its own stamp kernels'
records (the trailing ones, which belong to the replays still on the
ring), and the part of a segment that no kernel, copy or set record
covers goes to the segment `idle`, so that a layer's segments count the
device's work alone. `host_ms` sums a call's own phases and leaves out
the launch: under a profiler a graph's launch takes CUPTI's cost of each
of its kernels, tens of times its unprofiled cost. `export` writes the
same into the profiler's Chrome trace, host spans through the anchor.

**Registry.** The kernel wrappers' launches (`count`; a capture records
its stream's launches from any thread, autograd's device thread
included) and each captured program's record (`Record`: label, seconds,
pool bytes, launches, replays).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import sys
import threading
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# whether captures launch device marks; read when a capture begins. Off
# only to measure the marks' cost (the same program captured both ways)
MARKS = True
ROWS = 2048          # replays the device ring holds
COLS = 192           # marks a replay may take (the last kept for the close)
# each root's host spans, in the order a call's laps end them
PHASES = {"frame": ("frame.camera_in", "frame.key", "frame.inputs",
                    "frame.launch", "frame.outputs"),
          "step": ("step.bind", "step.inputs", "step.launch",
                   "step.outputs")}
FLUSH = 1024         # calls whose host spans are summed at once
ANCHOR = "tracing.anchor"
STAMP_KERNEL = "trace_stamp_kernel"
BACKWARD = "/backward"
IDLE = "idle"        # a replay's time that no device record covers
# a replay's stamps lie this far from their marks at most once aligned
# (microseconds); a replay beyond it is left unaligned
ALIGN_US = 50.0

_lock = threading.Lock()


class Registry:
    """Everything the tracer keeps, process-wide as the captures are."""

    def __init__(self):
        # capture stream (raw handle) -> the capture recording into it
        self.capturing: dict[int, Capture] = {}
        self.rings: dict[int, Ring] = {}        # device index -> ring
        self.records: list[Record] = []
        self.host_ns: collections.Counter = collections.Counter()
        self.host_calls: collections.Counter = collections.Counter()
        # each root's calls not yet summed: their lap times
        self.pending: dict = {root: [] for root in PHASES}
        self.host_events: list[HostRecord] = []
        self.session = 0          # profiler sessions seen
        self.in_session = False
        self.anchors: list[int] = []   # perf_counter_ns of each anchor
        self.profiler = None      # the last session's profile, if found


REG = Registry()


def reset() -> None:
    """Forget every record, counter, row and span (the rings stay)."""
    global REG
    with _lock:
        rings = REG.rings
        REG = Registry()
        for ring in rings.values():
            ring.replays, ring.tags = 0, [None] * ROWS
            ring.counter.zero_()
        REG.rings = rings


def _profiled() -> int:
    """The profiler session now running (its number), or 0: one flag read
    when no profiler runs. A session's first call opens the anchor."""
    if _autograd_profiler._is_profiler_enabled:
        if not REG.in_session:
            REG.in_session = True
            REG.session += 1
            t = perf_counter_ns()
            with record_function(ANCHOR):
                REG.anchors.append(t)
            REG.profiler = _held_profiler()
        return REG.session
    if REG.in_session:
        REG.in_session = False
    return 0


def _held_profiler():
    """The `torch.profiler.profile` that a caller up the stack holds in a
    local variable, or None: the session's device records, read once it
    has stopped."""
    frame = sys._getframe(2)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    return None


# ---------------------------------------------------------------------------
# Launch counts and captures
# ---------------------------------------------------------------------------

def _stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def count(wrapper) -> None:
    """One launch of `wrapper`'s kernel on the current stream: into the
    record of the capture on that stream, else on the wrapper."""
    if REG.capturing:
        cap = REG.capturing.get(_stream())
        if cap is not None:
            with _lock:
                cap.launches[wrapper.__name__] += 1
            return
    with _lock:
        wrapper.launches += 1


class Ring:
    """One device's ring of marks: (ROWS, COLS) int64 nanoseconds, the
    device's row counter, the host's count of the replays it tagged and
    each row's tag (replay number, record, profiler session)."""

    def __init__(self, device: torch.device):
        self.ring = torch.zeros((ROWS, COLS), dtype=torch.int64,
                                device=device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.replays = 0
        self.tags: list = [None] * ROWS

    def stamp(self, col: int, advance: bool, stream: int) -> None:
        if self.ring.device.type == "cpu":
            stamp_plain(self.ring, self.counter, col, advance)
            return
        from fourdgs_tpu_torch.ops._build import check_launch, load_library
        lib = load_library()
        check_launch(lib, "trace_stamp_launch", lib.trace_stamp_launch(
            self.ring.data_ptr(), self.counter.data_ptr(), ROWS, COLS, col,
            int(advance), stream))


def stamp_plain(ring: torch.Tensor, counter: torch.Tensor, col: int,
                advance: bool) -> None:
    """The stamp kernel's plain version: the host's nanosecond clock into
    column `col` of the counter's row."""
    r = int(counter[0])
    ring[r % ring.shape[0], col] = perf_counter_ns()
    if advance:
        counter[0] = r + 1


def ring(device: torch.device) -> Ring:
    """The device's ring, allocated at its first traced capture (before
    the capture begins)."""
    index = -1 if device.type == "cpu" else (
        device.index if device.index is not None
        else torch.cuda.current_device())
    with _lock:
        r = REG.rings.get(index)
        if r is None:
            r = REG.rings[index] = Ring(device)
        return r


@dataclasses.dataclass
class Record:
    """One captured program: its label and root span, the capture's
    seconds and the reserved bytes it added (its pool), its launches per
    kernel wrapper, its replays, and its marks' layout (the segment each
    column opens; None without marks)."""
    label: str
    root: str
    seconds: float = 0.0
    pool_bytes: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    replays: int = 0
    counted: int = 0          # replays before the last zero_counts
    opens: list | None = None
    tree: dict = dataclasses.field(default_factory=dict)
    ring: Ring | None = None
    dropped: int = 0          # marks past COLS, not launched


class Capture:
    """What one capture records on its stream: the kernel wrappers'
    launches and, with a ring, its marks (each column's segment, the span
    tree, the open segment and the stack of open spans)."""

    def __init__(self, stream: int, root: str, mark_ring: Ring | None):
        self.stream, self.root, self.ring = stream, root, mark_ring
        self.launches: collections.Counter = collections.Counter()
        self.opens: list = []
        self.tree: dict = {root: None}
        self.stack: list = []       # (span, segment open at its entry)
        self.open = root
        self.dropped = 0

    def _mark(self, opens, advance: bool = False) -> None:
        self.open = opens
        col = len(self.opens)
        if col >= COLS - 1 and not advance:
            self.dropped += 1
            return
        self.opens.append(opens)
        self.ring.stamp(col, advance, self.stream)

    def _parent(self) -> str:
        return self.stack[-1][0] if self.stack else self.root

    def enter(self, name: str) -> None:
        self.tree.setdefault(name, self._parent())
        self.stack.append((name, self.open))
        self._mark(name)

    def exit(self) -> None:
        _, before = self.stack.pop()
        self._mark(before)

    def point(self, label: str) -> None:
        self.tree.setdefault(label, self._parent())
        self._mark(label)


@contextlib.contextmanager
def capturing(stream, root: str | None = None, device=None):
    """Record the launches made on `stream` (a torch.cuda.Stream, or any
    object with a `cuda_stream` handle) inside the block and, with a
    `root` and MARKS, the marks of the program captured there: call
    `begin` after the capture begins and `end` before it ends."""
    handle = stream.cuda_stream
    mark_ring = ring(device) if root is not None and MARKS else None
    cap = Capture(handle, root, mark_ring)
    with _lock:
        if handle in REG.capturing:
            raise RuntimeError("two captures on one stream")
        REG.capturing[handle] = cap
    try:
        yield cap
    finally:
        with _lock:
            del REG.capturing[handle]


def begin(cap: Capture) -> None:
    """The root span's entry mark: the program's first kernel."""
    if cap.ring is not None:
        cap._mark(cap.root)


def end(cap: Capture, record: "Record") -> None:
    """The last mark (which moves the row counter on), and the capture's
    launches and layout into its record."""
    if cap.ring is not None:
        cap._mark(None, advance=True)
        record.opens, record.tree = cap.opens, cap.tree
        record.ring, record.dropped = cap.ring, cap.dropped
    record.launches = dict(cap.launches)


def program(label: str, root: str) -> Record:
    """A new program's record, kept in the registry."""
    rec = Record(label, root)
    with _lock:
        REG.records.append(rec)
    return rec


def replayed(rec: Record) -> int:
    """Count one replay of `rec` and tag its row; returns the replay's
    number on its ring (-1 for a program without marks)."""
    rec.replays += 1
    session = _profiled()
    r = rec.ring
    if r is None:
        return -1
    n = r.replays
    r.replays = n + 1
    r.tags[n % ROWS] = (n, rec, session)
    return n


def replayed_kernels() -> dict:
    """Kernel runs by wrapper name that replays made since the last
    `zero_counts`."""
    out: collections.Counter = collections.Counter()
    for rec in REG.records:
        n = rec.replays - rec.counted
        if n:
            for k, v in rec.launches.items():
                out[k] += n * v
    return dict(out)


def zero_counts(wrappers=()) -> None:
    """Start the launch counts over: the wrappers' and the replays'."""
    for w in wrappers:
        w.launches = 0
    for rec in REG.records:
        rec.counted = rec.replays


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class _BackwardMark(torch.autograd.Function):
    """The identity, whose backward marks `<span>/backward` on the
    capture's stream when the gradients of the span's outputs arrive."""

    @staticmethod
    def forward(ctx, cap, label, *xs):
        ctx.cap, ctx.label = cap, label
        # an output whose gradient never comes passes None, not zeros
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.cap.point(ctx.label)
        return (None, None, *grads)


class span:
    """A layer's span (see the module's docstring): a `record_function`
    range in an eager run, two device marks in a capture."""
    __slots__ = ("name", "cap", "rf")

    def __init__(self, name: str):
        self.name = name
        self.cap = None
        self.rf = None

    def __enter__(self):
        if REG.capturing:
            cap = REG.capturing.get(_stream())
            if cap is not None:
                if cap.ring is not None:
                    self.cap = cap
                    cap.enter(self.name)
                return self
        self.rf = record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cap is not None:
            self.cap.exit()
        elif self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def grads(self, *xs):
        """`xs` as they are, or in a capture that takes gradients, through
        the identity whose backward marks this span's backward. Returns a
        tuple; None and tensors without gradient pass through."""
        if self.cap is None or not torch.is_grad_enabled():
            return xs
        idx = [i for i, x in enumerate(xs)
               if isinstance(x, torch.Tensor) and x.requires_grad]
        if not idx:
            return xs
        marked = _BackwardMark.apply(self.cap, self.name + BACKWARD,
                                     *(xs[i] for i in idx))
        out = list(xs)
        for i, x in zip(idx, marked):
            out[i] = x
        return tuple(out)


@dataclasses.dataclass
class HostRecord:
    root: str
    replay: int
    session: int
    times: list               # ns: the call's start, then each phase's end

    def events(self) -> list:
        """(name, start ns, end ns) of each phase."""
        t = self.times
        return [(name, t[i], t[i + 1])
                for i, name in enumerate(PHASES[self.root])]


now = perf_counter_ns


class HostSpans:
    """The consecutive host phases of one call of `root` (PHASES):
    `lap(now())` ends the next phase, the first begun at creation;
    `close(replay)` files the call, and its phases under the replay's
    number while a profiler runs. `lap` is the list's own append, so that
    a frame's spans cost a few hundred nanoseconds."""
    __slots__ = ("root", "session", "times", "lap")

    def __init__(self, root: str):
        self.root = root
        self.session = (_profiled() if _autograd_profiler._is_profiler_enabled
                        or REG.in_session else 0)
        self.times = [perf_counter_ns()]
        self.lap = self.times.append

    def close(self, replay: int) -> None:
        pending = REG.pending[self.root]
        pending.append(self.times)
        if self.session:
            REG.host_events.append(HostRecord(self.root, replay,
                                              self.session, self.times))
        if len(pending) >= FLUSH:
            _flush(self.root)


def _flush(root: str) -> None:
    """Add the pending calls' phases to their counters: a phase's total is
    the sum of its end times less the sum of its start times."""
    pending = REG.pending[root]
    if not pending:
        return
    names = PHASES[root]
    if any(len(t) != len(names) + 1 for t in pending):
        raise RuntimeError(f"a {root} call lapped other than its phases "
                           f"{names}")
    sums = [sum(col) for col in zip(*pending)]
    for i, name in enumerate(names):
        REG.host_ns[name] += sums[i + 1] - sums[i]
    REG.host_calls[root] += len(pending)
    pending.clear()


def host_totals() -> tuple[dict, dict]:
    """Nanoseconds by host span and calls by root, every call counted."""
    for root in PHASES:
        _flush(root)
    return dict(REG.host_ns), dict(REG.host_calls)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def segments(times, opens, covered=None) -> dict:
    """Nanoseconds by segment of one replay's marks: `times[i]` the
    nanoseconds of column i, `opens[i]` the segment it opens. The marks
    are taken in time order (launch order breaks ties), and the interval
    from each to the next belongs to the segment the first opens. With
    `covered(a, b)`, the nanoseconds of the device's work within [a, b],
    the segment takes that part alone and IDLE the rest."""
    order = sorted(range(len(times)), key=lambda i: (times[i], i))
    out: dict = {}
    for a, b in zip(order, order[1:]):
        label, span = opens[a], times[b] - times[a]
        if covered is not None:
            work = min(span, covered(times[a], times[b]))
            out[IDLE] = out.get(IDLE, 0) + span - work
            span = work
        out[label] = out.get(label, 0) + span
    return out


def merged(intervals) -> tuple[list, list]:
    """The union of (start, end) intervals: the starts and the ends of
    its disjoint pieces, in order."""
    starts: list = []
    ends: list = []
    for a, b in sorted(intervals):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def covered_us(busy, lo: float, hi: float) -> float:
    """The length of [lo, hi] that the merged intervals `busy` cover."""
    starts, ends = busy
    i = bisect.bisect_right(ends, lo)
    got = 0.0
    while i < len(starts) and starts[i] < hi:
        got += min(ends[i], hi) - max(starts[i], lo)
        i += 1
    return got


@dataclasses.dataclass
class Row:
    """One replay's marks: its program's record, its number on the ring,
    its profiler session, each column's nanoseconds and, once aligned,
    the profiler-clock microseconds of its timer's 0 (`zero`)."""
    record: Record
    replay: int
    session: int
    times: list
    zero: float | None = None

    @property
    def first_to_last_ns(self) -> int:
        return max(self.times) - min(self.times)

    def segments(self, busy=None) -> dict:
        """Nanoseconds by segment; with the merged device records `busy`
        (on the profiler's clock) and the row aligned, the device's work
        by segment and its idle under IDLE."""
        if busy is None or self.zero is None:
            return segments(self.times, self.record.opens)
        zero = self.zero
        return segments(self.times, self.record.opens, lambda a, b: 1e3 * (
            covered_us(busy, zero + a / 1e3, zero + b / 1e3)))


def lost() -> int:
    """Replays whose rows later replays overwrote, on every ring."""
    return sum(max(0, r.replays - ROWS) for r in REG.rings.values())


def rows(session: int | None = None) -> list[Row]:
    """The replays still on the rings, in order, of profiler session
    `session` (None: every replay; 0: the unprofiled ones). Reads the
    rings back to the host after the device's work is done."""
    out = []
    for r in list(REG.rings.values()):
        first = max(0, r.replays - ROWS)
        tags = [r.tags[n % ROWS] for n in range(first, r.replays)]
        tags = [t for t in tags if t is not None
                and (session is None or t[2] == session)]
        if not tags:
            continue
        if r.ring.device.type == "cuda":
            torch.cuda.synchronize(r.ring.device)
        host = r.ring.cpu()
        for n, rec, sess in tags:
            times = host[n % ROWS, :len(rec.opens)].tolist()
            out.append(Row(rec, n, sess, times))
    return out


def last_session() -> int:
    return REG.session


def align(rows_: list[Row], stamp_us) -> int:
    """Put `rows_` (one session's, in replay order) on the profiler's
    clock. The stamp kernels' records (`stamp_us`, their starts) are
    matched, last with last, with the rows' marks in order: the trailing
    records belong to the replays still on the ring, the earlier ones to
    replays since overwritten. Each row takes the median offset of its own
    marks, since the card's timer and the profiler's clock can step apart
    between two replays by hundreds of microseconds. A row without a
    record for each mark, or whose records lie more than ALIGN_US from
    their marks, stays unaligned (`zero` None). Returns the rows
    aligned."""
    stamps = sorted(stamp_us)
    marks = [(t, k) for k, row in enumerate(rows_) for t in sorted(row.times)]
    n = min(len(stamps), len(marks))
    per: list = [[] for _ in rows_]
    for s, (m, k) in zip(stamps[len(stamps) - n:], marks[len(marks) - n:]):
        per[k].append(s - m / 1e3)
    aligned = 0
    for row, d in zip(rows_, per):
        row.zero = None
        if not d or len(d) != len(row.times):
            continue
        d.sort()
        mid = d[len(d) // 2]
        if d[-1] - mid <= ALIGN_US and mid - d[0] <= ALIGN_US:
            row.zero = mid
            aligned += 1
    return aligned


def profiler_records(prof):
    """A stopped profiler's device records, in its microseconds: the
    stamp kernels' starts and the merged intervals of every kernel, copy
    and set (ranges of `record_function` left out). None where it is still
    running or kept no device record."""
    from torch.autograd import DeviceType
    inner = getattr(prof, "profiler", None)
    if inner is None or getattr(inner, "kineto_results", None) is None:
        return None
    stamps, ivals = [], []
    for e in prof.events() or ():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        ivals.append((e.time_range.start, e.time_range.end))
        if STAMP_KERNEL in e.name:
            stamps.append(e.time_range.start)
    if not ivals:
        return None
    return stamps, merged(ivals)


def session_rows(session: int) -> tuple[list[Row], object]:
    """The session's rows and, where its profiler was found and has
    stopped with device records, those records merged (`busy`), the rows
    aligned to them."""
    got = rows(session)
    busy = None
    if session and session == REG.session and REG.profiler is not None:
        recs = profiler_records(REG.profiler)
        if recs is not None:
            stamps, busy = recs
            align(got, stamps)
    return got, busy


def segment_ms(root: str, session: int | None = None) -> dict:
    """Device milliseconds a replay by segment, the device's idle inside
    the replays under IDLE where the profiler's records split it out, and
    the first-to-last mean, over the profiled replays of `root` (the last
    session's by default). Where the records align some rows, those rows
    alone are read."""
    session = REG.session if session is None else session
    got, busy = session_rows(session)
    got = [row for row in got if row.record.root == root]
    if busy is not None and any(row.zero is not None for row in got):
        got = [row for row in got if row.zero is not None]
    else:
        busy = None
    out: dict = {}
    for row in got:
        for k, v in row.segments(busy).items():
            out[k] = out.get(k, 0.0) + v / 1e6 / len(got)
    if got:
        out["first_to_last"] = sum(r.first_to_last_ns for r in got) / len(
            got) / 1e6
    return out


def device_ms(root: str, spans) -> float | None:
    """Device milliseconds a replay of the programs rooted at `root` in
    the segments of `spans` (forward and backward), its work alone where
    the profiler's records split the idle out, over the last profiler
    session's replays; None where it kept none."""
    if not REG.session:
        return None
    segs = segment_ms(root)
    if not segs:
        return None
    spans = set(spans)
    return sum(v for k, v in segs.items() if k not in (None, IDLE,
               "first_to_last") and k.split(BACKWARD)[0] in spans)


def host_ms(root: str) -> float | None:
    """Host milliseconds a call of `root` spends in its own phases, every
    one but the launch (under a profiler the launch is CUPTI's cost of
    each kernel of the graph), over the last profiler session's calls;
    None where it kept none."""
    got = [h for h in REG.host_events
           if h.root == root and REG.session and h.session == REG.session]
    if not got:
        return None
    own = [i for i, name in enumerate(PHASES[root])
           if not name.endswith(".launch")]
    return sum(h.times[i + 1] - h.times[i] for h in got
               for i in own) / len(got) / 1e6


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def export(prof, path: str) -> dict:
    """Write `prof`'s Chrome trace to `path` with the program's host spans
    and device segments of its last session beside the profiler's own
    records, on the profiler's clock: the host spans through the anchor,
    each replay's segments through its own stamp records (`align`), each
    with the device's work and idle inside it. Returns what was added."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    anchors = [e["ts"] for e in events if e.get("name") == ANCHOR
               and e.get("ph") == "X"]
    session = REG.session
    added = {"host_spans": 0, "segments": 0, "rows": 0, "aligned": 0}
    if not anchors or not session:
        return added
    host = float(anchors[-1]) - REG.anchors[-1] / 1e3
    pid = "program"
    for h in REG.host_events:
        if h.session != session:
            continue
        for name, a, b in h.events():
            events.append({"ph": "X", "pid": pid, "tid": "host spans",
                           "name": name, "ts": host + a / 1e3,
                           "dur": (b - a) / 1e3,
                           "args": {"parent": h.root, "replay": h.replay}})
            added["host_spans"] += 1
    got = rows(session)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    busy = merged((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    added["rows"] = len(got)
    added["aligned"] = align(got, [e["ts"] for e in device
                                   if STAMP_KERNEL in e.get("name", "")])
    for row in got:
        if row.zero is None:
            continue
        order = sorted(range(len(row.times)),
                       key=lambda i: (row.times[i], i))
        opens, tree = row.record.opens, row.record.tree
        for a, b in zip(order, order[1:]):
            label = opens[a]
            lo = row.zero + row.times[a] / 1e3
            dur = (row.times[b] - row.times[a]) / 1e3
            work = covered_us(busy, lo, lo + dur)
            events.append({
                "ph": "X", "pid": pid, "tid": "device segments",
                "name": label, "ts": lo, "dur": dur,
                "args": {"parent": tree.get(label),
                         "program": row.record.label,
                         "replay": row.replay, "work_us": work,
                         "idle_us": dur - work}})
            added["segments"] += 1
    trace["traceEvents"] = events
    with open(path, "w") as f:
        json.dump(trace, f)
    return added


def summary() -> dict:
    """The registry's totals: host ns by span, calls by root, the
    programs' captures (label, seconds, pool bytes, replays), rows lost."""
    host_ns, host_calls = host_totals()
    return {"host_ns": host_ns, "host_calls": host_calls,
            "programs": [{"label": r.label, "seconds": r.seconds,
                          "pool_bytes": r.pool_bytes, "replays": r.replays,
                          "marks": None if r.opens is None
                          else len(r.opens), "marks_dropped": r.dropped}
                         for r in REG.records],
            "lost_rows": lost()}
