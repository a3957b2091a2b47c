"""What the benchmark reads from the machine: the card and the host, and the
reduction of a ``torch.profiler`` trace to busy time, idle gaps and the
device operations that took most time."""

from __future__ import annotations

import contextlib
import subprocess
from collections import defaultdict
from typing import NamedTuple

# the harness's own spans (``torch.profiler.record_function`` names)
SPAN_PREFIX = "bench/"
# idle gaps shorter than this are summed under one label, unlabelled
GAP_LABEL_MIN_US = 10.0
BREAKDOWN_ENTRIES = 10


def card_line() -> str:
    """The card's name, power limit and clocks as ``nvidia-smi`` reads them."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    return f"{q}: {out.stdout.strip() or out.stderr.strip()}"


def host_line() -> str:
    """The host's CPU (``/proc/cpuinfo``'s first processor) and the cores
    this process may use."""
    import os

    keys = ("model name", "vendor_id", "cpu family", "model", "cpu MHz")
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                k = k.strip()
                if k in keys and k not in info:
                    info[k] = v.strip()
                elif not k and info:
                    break
    except OSError:
        pass
    cpu = ", ".join(f"{k} {info[k]}" for k in keys if k in info) or "not read"
    return f"host CPU: {cpu}; {len(os.sched_getaffinity(0))} cores usable"


def _short(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


class Event(NamedTuple):
    name: str
    start: float  # us
    end: float  # us
    device: bool  # ran on the card
    thread: int
    annotation: bool  # a user annotation (a span), not an operation


@contextlib.contextmanager
def traced():
    """Trace the device (kernels, copies, sets, and the CUDA runtime's calls
    on the host) and, on the host, the harness's own spans alone: the
    profiler records no PyTorch operation, whose recording would slow the
    host path it measures.  Yields a list that holds the events (see
    :func:`events`) once the block has ended."""
    from torch._C._profiler import ProfilerActivity, RecordScope, _ExperimentalConfig
    from torch.autograd import (ProfilerConfig, ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    out: list = []
    try:
        yield out
    finally:
        out.extend(events(_disable_profiler()))


def events(result) -> list:
    """The events of a profiler's kineto result."""
    from torch.autograd import DeviceType

    out = []
    for e in result.events():
        start = e.start_ns() / 1e3
        ann = getattr(e, "is_user_annotation", None)
        out.append(Event(e.name(), start, start + e.duration_ns() / 1e3,
                         e.device_type() == DeviceType.CUDA, e.start_thread_id(),
                         bool(ann()) if callable(ann) else False))
    return out


def _is_device_op(e: Event) -> bool:
    return (e.device and not e.annotation and not e.name.startswith(SPAN_PREFIX)
            and "Sync" not in e.name)


def reduce(events: list) -> dict:
    """Busy and idle inside the harness's traced solves (the ``bench/solve``
    spans; what runs between them, such as the client's drawing of the next
    graph, is left out).  ``events``: :func:`events`.  Returns ``busy_s``
    (the union of the device operations' intervals inside the spans),
    ``window_s`` (the spans' summed length), ``device_ops`` (the operations
    that took most time, by name, seconds summed) and ``idle_gaps`` (idle
    device time by what the host was doing: the harness's span and the
    innermost host operation running in the gap's middle), each sorted, at
    most ``BREAKDOWN_ENTRIES`` long."""
    solves = sorted((e for e in events if e.name == SPAN_PREFIX + "solve" and not e.device),
                    key=lambda e: e.start)
    if not solves:
        return {}
    dev = [e for e in events if _is_device_op(e)]
    skipped: dict[str, int] = defaultdict(int)  # device records that are no operation
    for e in events:
        if e.device and not _is_device_op(e):
            skipped[_short(e.name)] += 1
    by_name: dict[str, float] = defaultdict(float)
    ivs = []
    for e in dev:
        for sp in solves:
            a, b = max(e.start, sp.start), min(e.end, sp.end)
            if b > a:
                ivs.append((a, b))
                by_name[_short(e.name)] += (b - a) * 1e-6
    ivs.sort()
    busy, gaps = 0.0, []
    i = 0
    for sp in solves:
        cur = sp.start
        while i < len(ivs) and ivs[i][0] < sp.end:
            a, b = ivs[i]
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
            i += 1
        if sp.end > cur:
            gaps.append((cur, sp.end))
    window = sum(sp.end - sp.start for sp in solves)

    main = solves[0].thread
    host = sorted((e for e in events if not e.device and e.thread == main), key=lambda e: e.start)
    idle: dict[str, float] = defaultdict(float)
    long_gaps = []
    for g0, g1 in gaps:
        if g1 - g0 < GAP_LABEL_MIN_US:
            idle[f"gaps under {GAP_LABEL_MIN_US:g} us"] += (g1 - g0) * 1e-6
        else:
            long_gaps.append((0.5 * (g0 + g1), g1 - g0))
    # a sweep over the gaps' middles: the host events that have started and
    # not yet ended there
    active, i = [], 0
    for mid, length in long_gaps:
        while i < len(host) and host[i].start <= mid:
            active.append(host[i])
            i += 1
        active = [e for e in active if e.end >= mid]
        spans = [e for e in active if e.name.startswith(SPAN_PREFIX)]
        ops = [e for e in active if not e.name.startswith(SPAN_PREFIX)]
        span = min(spans, key=lambda e: e.end - e.start, default=None)
        op = min(ops, key=lambda e: e.end - e.start, default=None)
        label = (span.name.removeprefix(SPAN_PREFIX) if span else "outside the solves") + (
            f": {_short(op.name)}" if op is not None else "")
        idle[label] += length * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

    return {"busy_s": busy * 1e-6, "window_s": window * 1e-6, "solves": len(solves),
            "device_ops": top(by_name), "idle_gaps": top(idle), "device_events": len(dev),
            "skipped": dict(sorted(skipped.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES])}
