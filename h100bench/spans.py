"""Device time charged to the program's named spans (`ctdd.*`).

The program opens `torch.profiler.record_function` ranges at its layer
boundaries while a profiler records (`ctdd_tpu_torch/utils/trace.py`). One
more profiled segment of the cell's own call, after the one `--trace 1`
already keeps, is read here from its Chrome trace, by these rules:

- A kernel (or copy, or fill) belongs to the host call that launched it:
  the profiler's `correlation` leads from the kernel to its launch event,
  and the launch's enclosing ranges on its thread give its spans.
- A backward op (`autograd::engine::evaluate_function: XBackward0`) belongs
  to the spans of the forward op that made its node: the two share a
  `Sequence number`. What the backward launches beside those (on the card,
  from the autograd engine's own thread) belongs to the span open on the
  host at its launch: `ctdd.train.backward`.
- A device op is charged to its innermost span; a span's self time is what
  is charged to it alone, its time what is charged to it or a span inside.
- The device's idle time (the segment less the union of its device ops) is
  charged to the innermost span the host was in.

On the CPU (the harness's own tests) no kernels exist; the innermost host
ops stand in for them, anchored to themselves.

The kinds hand their readers no way to run a segment again; `of(ctx)` takes
the call from the kind's frame, where it stands beside the `Context` the
readers were given (`advance` and `n_prof` in `kinds/train.py`, `batch` and
`steps` in `kinds/sample.py`). A program without spans, or a cell of
several ranks (whose segment needs every rank), reads None.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from h100bench import common

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"

PREFIX = "ctdd."
SEGMENT = "h100bench.segment"  # the harness's marker of the profiled call
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function:"
EPS_US = 0.05  # the trace's rounding of start and duration

Path_ = Tuple[str, ...]  # the spans from the outermost to the innermost


@dataclasses.dataclass
class Charges:
    """One segment's device time, device ops and idle time (us) by span
    path; `calls` counts each span's host ranges; `units` the steps the
    segment held."""

    units: int
    device_us: Dict[Path_, float]
    ops: Dict[Path_, int]
    idle_us: Dict[Path_, float]
    calls: Dict[str, int]
    busy_us: float
    charged_us: float
    unattributed: Dict[str, float]

    def _per_unit(self, table: Dict[Path_, float], name: str, self_only: bool) -> float:
        hit = (lambda p: p[-1:] == (name,)) if self_only else (lambda p: name in p)
        return sum(v for p, v in table.items() if hit(p)) / self.units

    def device_ms(self, name: str, self_only: bool = False) -> float:
        """Device ms a unit charged to span `name` (alone, with
        `self_only`; else with the spans inside it)."""
        return self._per_unit(self.device_us, name, self_only) / 1e3

    def idle_ms(self, name: str) -> float:
        """Idle device ms a unit while the host was inside span `name`."""
        return self._per_unit(self.idle_us, name, False) / 1e3

    def summary(self) -> dict:
        """Per unit, by span path: device ms, device ops, idle ms; the
        share of the busy time charged to a span."""
        paths = sorted(set(self.device_us) | set(self.idle_us))
        return {
            "units": self.units, "busy_ms": self.busy_us / 1e3 / self.units,
            "charged_pct": 100.0 * self.charged_us / self.busy_us if self.busy_us else None,
            "calls": self.calls,
            "by_span": {"/".join(p) or "(none)": [
                round(self.device_us.get(p, 0.0) / 1e3 / self.units, 4),
                round(self.ops.get(p, 0) / self.units, 2),
                round(self.idle_us.get(p, 0.0) / 1e3 / self.units, 4)] for p in paths},
            "unattributed_ms": {n: round(v / 1e3 / self.units, 4) for n, v in sorted(
                self.unattributed.items(), key=lambda kv: -kv[1])[:5]},
        }


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


def _nest(events: List[dict]) -> Dict[int, tuple]:
    """For each host event (by id), (its span path, the sequence number of
    the innermost backward op around it or None), from the ranges that
    enclose it on its thread."""
    out: Dict[int, tuple] = {}
    by_tid: Dict[object, List[dict]] = {}
    for e in events:
        by_tid.setdefault(e.get("tid"), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -_end(e)))
        stack: List[tuple] = []  # (end, path, seq)
        for e in evs:
            s, end = float(e["ts"]), _end(e)
            while stack and stack[-1][0] + EPS_US < end:
                stack.pop()
            path, seq = (stack[-1][1], stack[-1][2]) if stack else ((), None)
            name = e.get("name", "")
            if e.get("cat") == "user_annotation" and name.startswith(PREFIX):
                path = path + (name,)
            elif name.startswith(BACKWARD):
                seq = e.get("args", {}).get("Sequence number", seq)
            out[id(e)] = (path, seq)
            stack.append((end, path, seq))
    return out


def charge(events: List[dict], units: int, cpu: bool = False) -> Charges:
    """The charges of one segment's Chrome-trace events (`traceEvents`),
    bounded by the harness's `SEGMENT` range where it is there."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    host = [e for e in xs if e.get("cat") in HOST]
    nested = _nest(host)
    spans = sorted(((float(e["ts"]), _end(e), nested[id(e)][0]) for e in host
                    if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)),
                   key=lambda sp: sp[0])
    starts = [sp[0] for sp in spans]
    calls: Dict[str, int] = {}
    for _, _, p in spans:
        calls[p[-1]] = calls.get(p[-1], 0) + 1

    # forward ops by sequence number: (start, path), in time order
    forward: Dict[int, List[tuple]] = {}
    for e in host:
        args = e.get("args", {})
        if e.get("cat") == "cpu_op" and "Sequence number" in args and \
                not args.get("Fwd thread id") and not e["name"].startswith(BACKWARD):
            forward.setdefault(args["Sequence number"], []).append(
                (float(e["ts"]), nested[id(e)][0]))
    for v in forward.values():
        v.sort(key=lambda f: f[0])

    def open_span(t: float) -> Path_:
        """The innermost span on any thread open at `t`."""
        best: Path_ = ()
        for s, e, p in spans[:bisect.bisect_right(starts, t)]:
            if e >= t and len(p) > len(best):
                best = p
        return best

    def path_of(anchor: dict) -> Path_:
        path, seq = nested[id(anchor)]
        t = float(anchor["ts"])
        if seq is not None and seq in forward:
            made = [p for s, p in forward[seq] if s <= t]
            if made:
                return made[-1]
        return path or open_span(t)

    if cpu:
        # a leaf op: no cpu_op starts inside it on its thread
        parents = set()
        ops_cpu = sorted((e for e in host if e.get("cat") == "cpu_op"),
                         key=lambda e: (e.get("tid"), float(e["ts"]), -_end(e)))
        for a, b in zip(ops_cpu, ops_cpu[1:]):
            if a.get("tid") == b.get("tid") and float(b["ts"]) < _end(a):
                parents.add(id(a))
        device = [(e, e) for e in ops_cpu if id(e) not in parents]
    else:
        launches = {e["args"]["correlation"]: e for e in host
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        device = [(e, launches.get(e.get("args", {}).get("correlation")))
                  for e in xs if e.get("cat") in DEVICE]

    seg = [e for e in host if e.get("name") == SEGMENT]
    lo = float(seg[0]["ts"]) if seg else min((float(e["ts"]) for e, _ in device), default=0.0)
    hi = _end(seg[0]) if seg else max((_end(e) for e, _ in device), default=0.0)

    device_us: Dict[Path_, float] = {}
    ops: Dict[Path_, int] = {}
    unattributed: Dict[str, float] = {}
    charged = []
    for e, anchor in device:
        p = path_of(anchor) if anchor is not None else ()
        dur = float(e.get("dur", 0.0))
        device_us[p] = device_us.get(p, 0.0) + dur
        ops[p] = ops.get(p, 0) + 1
        if p:
            charged.append(("", float(e["ts"]), _end(e)))
        else:
            unattributed[e["name"][:80]] = unattributed.get(e["name"][:80], 0.0) + dur
    busy = common.union(("", float(e["ts"]), _end(e)) for e, _ in device)
    busy_us = sum(b - a for a, b in busy)
    charged_us = sum(b - a for a, b in common.union(charged))
    idle = []
    cursor = lo
    for a, b in busy:
        if a > cursor:
            idle.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
    if cursor < hi:
        idle.append((cursor, hi))
    return Charges(units=units, device_us=device_us, ops=ops, idle_us=_idle_by_span(idle, spans),
                   calls=calls, busy_us=busy_us, charged_us=charged_us,
                   unattributed=unattributed)


def _idle_by_span(idle: List[tuple], spans: List[tuple]) -> Dict[Path_, float]:
    """The idle intervals' length by the innermost span open on the host."""
    points = []
    for s, e in idle:
        if e > s:
            points += [(s, 1, "idle", None), (e, 0, "idle", None)]
    for k, (s, e, p) in enumerate(spans):
        points += [(s, 1, k, p), (e, 0, k, p)]
    points.sort(key=lambda q: (q[0], q[1]))
    out: Dict[Path_, float] = {}
    open_spans: Dict[int, Path_] = {}
    idle_open, last = 0, None
    for t, opening, key, p in points:
        if last is not None and idle_open and t > last:
            here = max(open_spans.values(), key=len, default=())
            out[here] = out.get(here, 0.0) + (t - last)
        last = t
        if key == "idle":
            idle_open += 1 if opening else -1
        elif opening:
            open_spans[key] = p
        else:
            open_spans.pop(key, None)
    return out


def measure(fn: Callable, units: int, device) -> Charges:
    """Run `fn` (`units` steps) under torch.profiler inside the harness's
    marker and charge its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = getattr(device, "type", device) == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(SEGMENT):
            fn()
            if cuda:
                torch.cuda.synchronize(device)
    CACHE.mkdir(parents=True, exist_ok=True)
    path = CACHE / f"spans_{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return charge(events, units, cpu=not cuda)


def _segment_call(ctx, frame) -> Optional[tuple]:
    """(call, units, device) of the kind whose frame holds `ctx`."""
    while frame is not None:
        loc = frame.f_locals
        if loc.get("ctx") is ctx:
            if "advance" in loc and "n_prof" in loc and loc.get("ranks") == 1:
                advance, n = loc["advance"], int(loc["n_prof"])
                return (lambda: advance(n)), n, loc["dev"]
            if "batch" in loc and "steps" in loc:
                batch = loc["batch"]
                return (lambda: batch(0)), int(loc["steps"]), loc["dev"]
        frame = frame.f_back
    return None


def of(ctx) -> Optional[Charges]:
    """The charges of one more segment of the run that made `ctx` (a
    `--trace 1` run), measured once a run; None where the program opens no
    spans or the segment cannot be run again."""
    if ctx.trace is None:
        return None
    if not hasattr(ctx, "span_charges"):
        found = None
        if "ctdd_tpu_torch.utils.trace" in sys.modules:
            found = _segment_call(ctx, sys._getframe(1))
        ctx.span_charges = None
        if found is not None:
            fn, units, device = found
            ctx.span_charges = measure(fn, units, device)
            if not ctx.span_charges.calls:
                ctx.span_charges = None
            else:
                print("spans: " + json.dumps(ctx.span_charges.summary()), file=sys.stderr)
    return ctx.span_charges
