"""Readings of the program's own spans (mfmg_torch/utils/trace.py) over the
cell's traffic, for the per-layer metrics that read them.

Two stretches of ``trace_requests`` requests, each made once per run and
kept on the context, each with the program's tracing on and always off
again after it:

- the host stretch, with no profiler: the spans' host durations (a profiler
  slows the host, so host times come from this stretch alone);
- the device stretch, under a CUDA-activity profile: each device operation
  goes to the span that was innermost on the host when it was launched (the
  runtime call that the profiler links to it by correlation id), and the
  device's idle time to the span that was innermost then.  The spans open
  no ``record_function`` ranges here; a device event named as a span would
  be no device work, and is left out.

Spans are stamped on the profiler's clock, so the two compare without
conversion.  A program without the tracing module (an older one) and a run
without a card read None, and leave tracing as it was."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import statistics

NO_SPAN = "(no span)"
TRANSFER = re.compile(r"^L\d+\.(restrict|prolong)$")
EIGENSOLVE = re.compile(r"^(light batch L0|batch L0|host eigensolve L0"
                        r"|device eigensolve L0: .*|eigensolve L0 \(.*\))$")
RESTRICTOR = re.compile(r"^restrictor L[1-9]\d*$")
TOP = 10
KERNEL_CHARS = 60


def trace_module():
    """The program's tracing module, or None where it has none."""
    try:
        from mfmg_torch.utils import trace
    except ImportError:
        return None
    return trace


@dataclasses.dataclass
class Stretch:
    """A stretch of ``n`` requests with tracing on: its spans, its bounds on
    the spans' clock (synchronised at both ends), the spans opened per name,
    and (the device stretch) its device operations as (start_ns, end_ns,
    name, launch_ns or None)."""
    n: int
    t0: int
    t1: int
    spans: list
    counts: dict
    device: list = None

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) / 1e9


def _timed(ctx, trace, on=True):
    """(t0, t1) on the spans' clock of ``trace_requests`` requests, the
    device synchronised at the end, with tracing ``on`` (no
    ``record_function`` ranges: each costs the host microseconds under a
    profiler) or off."""
    pool, n = ctx.pool, ctx.traffic["trace_requests"]
    if on:
        trace.enable(profiler_ranges=False)
    try:
        t0 = trace.now()
        for k in range(n):
            ctx.serve(pool[k % pool.shape[0]])
        ctx.system.synchronize()
        return t0, trace.now()
    finally:
        trace.disable()


def _run(ctx, trace, profiled=False):
    """The stretch, after one request outside it; ``profiled``: under a
    CUDA-activity profile, with its device operations.  None where the
    program's buffer dropped spans: a cut-off list reads wrong numbers."""
    ctx.serve(ctx.pool[0])
    ctx.system.synchronize()
    trace.take()
    prof = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    with prof or contextlib.nullcontext():
        t0, t1 = _timed(ctx, trace)
    counts, dropped = trace.counts(), trace.dropped()
    spans = trace.take()
    if dropped:
        ctx.notes["spans_dropped"] = dropped
        return None
    st = Stretch(ctx.traffic["trace_requests"], t0, t1, spans, counts)
    if prof is not None:
        st.device = _device_ops(prof, {s.name for s in st.spans})
    return st


def _device_ops(prof, span_names) -> list:
    """(start_ns, end_ns, name, launch_ns) of the profile's device
    operations, the launch the start of the runtime call (``cuda*``,
    ``cu*``) with the same correlation id (None where there is none).  Only
    the event methods that torch's profiler has had since 2.1 are used."""
    from torch.autograd import DeviceType
    launch, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in span_names:
                ops.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    return [(s, e, name, launch.get(c)) for s, e, name, c in ops]


def host_stretch(ctx):
    """The host stretch (made once), or None."""
    trace = trace_module()
    if not ctx.cuda or trace is None:
        return None
    memo = ctx.__dict__.setdefault("_spans", {})
    if "host" not in memo:
        st = memo["host"] = _run(ctx, trace)
        if st is not None:
            ctx.notes["spans_per_request"] = {
                k: round(v / st.n, 2) for k, v in sorted(st.counts.items())}
    return memo["host"]


def device_stretch(ctx):
    """The device stretch (made once), or None."""
    trace = trace_module()
    if not ctx.cuda or trace is None:
        return None
    memo = ctx.__dict__.setdefault("_spans", {})
    if "device" not in memo:
        st = memo["device"] = _run(ctx, trace, profiled=True)
        if st is not None:
            _device_notes(ctx, st)
    return memo["device"]


def _device_notes(ctx, st):
    """The device stretch's idle seconds by innermost span and device ms by
    kernel and launching span, the top ``TOP`` of each."""
    idle = idle_by_span(st, innermost(st.spans, st.t0, st.t1))
    ctx.notes["idle_s_by_span"] = [[k, round(v, 6)] for k, v in idle[:TOP]]
    by = {}
    unlinked = 0
    for (s, e, name, _), i in zip(st.device, launched_in(st)):
        unlinked += i is None
        key = (name[:KERNEL_CHARS],
               NO_SPAN if i in (None, -1) else st.spans[i].name)
        by[key] = by.get(key, 0.0) + (e - s) / 1e6
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    ctx.notes["device_ms_by_kernel_and_span"] = [
        [k, sp, round(v, 4)] for (k, sp), v in top]
    ctx.notes["device_ops_unlinked"] = unlinked
    ctx.notes["device_stretch_s"] = st.wall_s


def innermost(spans, t0: int, t1: int) -> list:
    """[(start, end, index)] covering [t0, t1] in time order: at each time
    the index of the innermost span open then, -1 where none is.  Spans
    nest, and come in start order with their parents' indices."""
    segs, stack, t = [], [], t0

    def cut(until, index):
        nonlocal t
        if until > t:
            segs.append((t, until, index))
            t = until

    def close(until):
        while stack and spans[stack[-1]].end_ns <= until:
            i = stack.pop()
            cut(min(spans[i].end_ns, t1), i)

    for i, s in enumerate(spans):
        if s.end_ns <= t0 or s.start_ns >= t1:
            continue
        close(s.start_ns)
        cut(max(s.start_ns, t0), stack[-1] if stack else -1)
        stack.append(i)
    close(t1)
    while stack:
        cut(t1, stack.pop())
    cut(t1, -1)
    return segs


def launched_in(st: Stretch) -> list:
    """For each device operation of the stretch, the index of the innermost
    span open at its launch (-1: none; None: no launch linked to it)."""
    segs = innermost(st.spans, st.t0, st.t1)
    starts = [s for s, _, _ in segs]
    out = []
    for *_, t in st.device:
        if t is None:
            out.append(None)
            continue
        k = bisect.bisect_right(starts, t) - 1
        out.append(segs[k][2] if k >= 0 and t < segs[k][1] else -1)
    return out


def _busy(device, t0, t1) -> list:
    """The union of the device intervals, clipped to [t0, t1]."""
    out = []
    for s, e, *_ in sorted(device, key=lambda d: d[0]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_span(st: Stretch, segs) -> list:
    """[(name, seconds)] of the device's idle time in the stretch, by the
    innermost span open on the host then, the longest first."""
    idle, t = [], st.t0
    for s, e in _busy(st.device, st.t0, st.t1):
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if st.t1 > t:
        idle.append((t, st.t1))
    by, k = {}, 0
    for s, e in idle:
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < e:
            a, b, i = segs[j]
            name = NO_SPAN if i == -1 else st.spans[i].name
            by[name] = by.get(name, 0.0) + (min(b, e) - max(a, s)) / 1e9
            j += 1
    return sorted(by.items(), key=lambda kv: -kv[1])


def _mean_ms(spans, name):
    d = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return statistics.fmean(d) / 1e6 if d else None


def vcycle_host_ms(ctx):
    """Mean host ms of a ``vcycle`` span over the host stretch."""
    st = host_stretch(ctx)
    return None if st is None else _mean_ms(st.spans, "vcycle")


def pcg_host_ms(ctx):
    """Per solve of the host stretch, the ``solve`` span less the time of
    its ``vcycle`` and ``sync`` spans (the outer CG's own dispatch); mean,
    ms."""
    st = host_stretch(ctx)
    if st is None:
        return None
    own = {}
    for s in st.spans:
        d = s.end_ns - s.start_ns
        if s.name == "solve":
            own[s.request] = own.get(s.request, 0) + d
        elif s.name in ("vcycle", "sync") and s.request in own:
            own[s.request] -= d
    return statistics.fmean(own.values()) / 1e6 if own else None


def transfer_device_ms(ctx):
    """Device ms per V-cycle of the operations launched inside a
    ``L<l>.restrict`` or ``L<l>.prolong`` span, over the device stretch."""
    st = device_stretch(ctx)
    if st is None:
        return None
    n_cycles = sum(s.name == "vcycle" for s in st.spans)
    if not n_cycles or not st.device:
        return None
    under = []                          # inside a transfer span, by index
    for s in st.spans:
        under.append(bool(TRANSFER.match(s.name))
                     or (s.parent >= 0 and under[s.parent]))
    ns = sum(e - s for (s, e, *_), i in zip(st.device, launched_in(st))
             if i is not None and i >= 0 and under[i])
    return ns / 1e6 / n_cycles


def dispatch_idle_share(ctx):
    """The share of the device stretch's wall in which the device is idle
    while a program span other than ``sync`` is innermost on the host, %."""
    st = device_stretch(ctx)
    if st is None or st.t1 <= st.t0:
        return None
    idle = idle_by_span(st, innermost(st.spans, st.t0, st.t1))
    s = sum(v for k, v in idle if k not in (NO_SPAN, "sync"))
    return 100.0 * s / st.wall_s


def stage_sum(ctx, pattern):
    """The sum of the hierarchy's synchronised set-up stages whose names
    match ``pattern``, s; the stage table goes to the notes."""
    if not ctx.cuda or trace_module() is None:
        return None
    stages = ctx.system.hier.setup_seconds
    if "setup_stages_s" not in ctx.notes:
        ctx.notes["setup_stages_s"] = {k: round(v, 4) for k, v in stages.items()}
        ctx.notes["setup_stages_sum_s"] = sum(stages.values())
    hit = [v for k, v in stages.items() if pattern.match(k)]
    return sum(hit) if hit else None
