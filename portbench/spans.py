"""The program's own spans in a Kineto trace (``spectre_tpu_torch/profile/
spans.py`` opens them while a profiler records), and the card's work and
idle time put down to them.

A program span is a ``user_annotation`` whose name is ``step`` or starts
with ``data/``, ``step/`` or ``op/``. Attribution:

- A device event (kernel, copy, fill) belongs to the spans that hold its
  launch: the ``cuda_runtime`` or ``cuda_driver`` event with the same
  correlation id, on the thread that launched it.
- Phase spans (all but ``op/*``) are also tied by time: a launch on a thread
  with no program span of its own (the autograd engine's) belongs to the
  program spans that other threads hold at that moment, so a backward kernel
  falls under ``step/backward``.
- ``op/*`` spans take their backward work through the autograd sequence
  number: the ``autograd::engine::evaluate_function: ...`` event around the
  launch carries one, the forward operator with that number (the latest to
  start; it made the node) lies in the innermost ``op/*`` span of its
  thread, and that span gets the launch.
- Device idle time, inside the ``portbench.window`` annotation, belongs to
  the program spans that hold the window's thread at that moment, or to
  none; then the innermost host event of that thread over the moment says
  what the host was doing.

Times are clipped to the window, as ``tracing.summarize`` clips them, and
device time is the sum of the events' durations (streams may overlap).
"""

from __future__ import annotations

import bisect
import json
import re

from portbench.kernel_names import DEVICE_CATEGORIES, short_name
from portbench.tracing import HOST_CATEGORIES, WINDOW, _union

PROGRAM_SPAN = re.compile(r"^(step|(data|step|op)/[A-Za-z0-9_.-]+)$")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
EVALUATE = "autograd::engine::evaluate_function: "
TOP_OPS = 8


def group(name: str) -> str:
    """``data``, ``step`` or ``op``: the layer a program span belongs to."""
    return name.split("/", 1)[0]


class _Timeline:
    """The stack of properly nested intervals of one thread at any moment:
    ``at(t)`` is the tuple of the events that hold ``t``, outermost first."""

    def __init__(self, events: list[dict]):
        marks = []
        for i, e in enumerate(events):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b > a:
                marks.append((a, 1, -(b - a), i))
                marks.append((b, 0, 0.0, i))
        marks.sort()
        self.times: list[float] = []
        self.stacks: list[tuple] = []
        stack: list[int] = []
        for t, opening, _, i in marks:
            if opening:
                stack.append(i)
            else:
                stack.remove(i)
            if self.times and self.times[-1] == t:
                self.stacks[-1] = tuple(events[j] for j in stack)
            else:
                self.times.append(t)
                self.stacks.append(tuple(events[j] for j in stack))

    def at(self, t: float) -> tuple:
        k = bisect.bisect_right(self.times, t) - 1
        return self.stacks[k] if k >= 0 else ()

    def pieces(self, a: float, b: float):
        """(start, end, stack) of the stretches of [a, b) with one stack."""
        k = bisect.bisect_right(self.times, a) - 1
        while a < b:
            end = min(self.times[k + 1], b) if k + 1 < len(self.times) else b
            yield a, end, self.stacks[k] if k >= 0 else ()
            a, k = end, k + 1


def _threads(events: list[dict]) -> dict:
    by: dict = {}
    for e in events:
        by.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    return {k: _Timeline(v) for k, v in by.items()}


def summarize_spans(events: list[dict]) -> dict:
    """From a trace's events with one ``portbench.window`` annotation:

    - ``spans``: for each program span's name, ``calls`` and ``host_s``
      (instances and their time on the host, inside the window),
      ``device_s`` (device time launched under it, nested spans included),
      ``self_device_s`` (where it is the innermost), ``idle_s`` and
      ``self_idle_s`` (device idle time under it); ``ops``, the
      ``TOP_OPS`` device operations (``kernel_names.short_name``) that take
      most of its self device time, and ``sites``, the same by operation
      and call site (the backward node, and the outermost and innermost
      operator around the launch on its thread); for an ``op/*`` span
      ``phases``, its device time by the innermost phase span over it;
    - ``groups``: ``device_s`` and ``idle_s`` under any span of a layer
      (``data``, ``step``, ``op``), counted once where they nest;
    - ``device_s``, ``device_events``, ``idle_s`` of the window, and
      ``clock_lead_s``, the most by which a device event starts before the
      call that launched it: the error of the device clock's conversion to
      the host's, which tying idle time to host spans inherits;
      ``unattributed``: device time under no span (``device_s``, its
      ``ops``, and ``no_launch_s``, events whose launch the trace lacks) and
      idle time under no span (``idle_s``, and ``host``, the innermost host
      event over each stretch of it, by total time).
    """
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat") != "gpu_user_annotation"]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span in the trace, found {len(windows)}")
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    main = (win.get("pid"), win.get("tid"))

    program = [e for e in spans if e.get("cat") == "user_annotation"
               and PROGRAM_SPAN.match(e.get("name", ""))]
    own = _threads(program)
    phases = _threads([e for e in program if group(e["name"]) != "op"])
    operators = [e for e in spans if e.get("cat") == "cpu_op"]
    calls = _threads(operators)
    evaluates = _threads([e for e in operators if e.get("name", "").startswith(EVALUATE)])
    forward: dict = {}  # sequence number -> the latest forward operator with it
    for e in spans:
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None or args.get("Fwd thread id") \
                or e.get("name", "").startswith(EVALUATE):
            continue
        if seq not in forward or float(e["ts"]) > float(forward[seq]["ts"]):
            forward[seq] = e
    launches = {}
    for e in spans:
        if e.get("cat") in LAUNCH_CATEGORIES:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e

    def op_of(e: dict) -> dict | None:
        stack = own[(e.get("pid"), e.get("tid"))].at(float(e["ts"])) \
            if (e.get("pid"), e.get("tid")) in own else ()
        ops = [s for s in stack if group(s["name"]) == "op"]
        return ops[-1] if ops else None

    def path_of(launch: dict) -> tuple[str, ...]:
        key, t = (launch.get("pid"), launch.get("tid")), float(launch["ts"])
        stack = own[key].at(t) if key in own else ()
        if not stack:  # a thread of no span of its own: the phases other threads hold
            held = [s for k, tl in phases.items() if k != key for s in tl.at(t)]
            stack = tuple(sorted(held, key=lambda s: (float(s["ts"]), -float(s["dur"]))))
        names = [s["name"] for s in stack]
        if not any(group(n) == "op" for n in names) and key in evaluates:
            ev = evaluates[key].at(t)
            seq = (ev[-1].get("args") or {}).get("Sequence number") if ev else None
            op = op_of(forward[seq]) if seq in forward else None
            if op is not None:
                names.append(op["name"])
        return tuple(dict.fromkeys(names))

    def site_of(launch: dict) -> str:
        key = (launch.get("pid"), launch.get("tid"))
        names = [s["name"] for s in (calls[key].at(float(launch["ts"])) if key in calls else ())]
        node = [n[len(EVALUATE):] for n in names if n.startswith(EVALUATE)]
        ops = [n for n in names if not n.startswith(EVALUATE)]
        return " > ".join(dict.fromkeys(node[-1:] + ops[:1] + ops[-1:])) or "no operator"

    table: dict = {}

    def row(name: str) -> dict:
        return table.setdefault(name, {"calls": 0, "host_s": 0.0, "device_s": 0.0,
                                       "self_device_s": 0.0, "idle_s": 0.0, "self_idle_s": 0.0,
                                       "ops": {}, "sites": {}, "phases": {}})

    groups: dict = {}
    for e in program:
        a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
        if b > a:
            r = row(e["name"])
            r["calls"] += 1
            r["host_s"] += (b - a) * 1e-6
            groups.setdefault(group(e["name"]), {"device_s": 0.0, "idle_s": 0.0})
    device_s, n_device, busy, lead = 0.0, 0, [], 0.0
    loose = {"device_s": 0.0, "no_launch_s": 0.0, "ops": {}}
    for e in spans:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        secs = (b - a) * 1e-6
        device_s += secs
        n_device += 1
        busy.append((a, b))
        op = short_name(e.get("name", "?"))
        launch = launches.get((e.get("args") or {}).get("correlation"))
        path = path_of(launch) if launch is not None else ()
        if launch is not None:
            lead = max(lead, float(launch["ts"]) - float(e["ts"]))
        if not path:
            loose["device_s"] += secs
            loose["no_launch_s"] += secs if launch is None else 0.0
            loose["ops"][op] = loose["ops"].get(op, 0.0) + secs
            continue
        phase = next((n for n in reversed(path) if group(n) != "op"), "none")
        for name in path:
            r = row(name)
            r["device_s"] += secs
            if group(name) == "op":
                r["phases"][phase] = r["phases"].get(phase, 0.0) + secs
        inner = row(path[-1])
        inner["self_device_s"] += secs
        inner["ops"][op] = inner["ops"].get(op, 0.0) + secs
        where = (op, site_of(launch))
        inner["sites"][where] = inner["sites"].get(where, 0.0) + secs
        for g in dict.fromkeys(group(n) for n in path):  # a span may open before the window
            groups.setdefault(g, {"device_s": 0.0, "idle_s": 0.0})["device_s"] += secs

    busy = _union(busy)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle_s = sum(b - a for a, b in gaps) * 1e-6
    main_spans = own.get(main)
    host = _threads([e for e in spans if e.get("cat") in HOST_CATEGORIES
                     and (e.get("pid"), e.get("tid")) == main and e.get("name") != WINDOW])
    loose_idle, doing = 0.0, {}
    for a, b in gaps:
        for p0, p1, stack in (main_spans.pieces(a, b) if main_spans else [(a, b, ())]):
            secs = (p1 - p0) * 1e-6
            names = list(dict.fromkeys(s["name"] for s in stack))
            if not names:
                loose_idle += secs
                over = host[main].at((p0 + p1) / 2) if main in host else ()
                what = over[-1]["name"] if over else "no host event"
                doing[what] = doing.get(what, 0.0) + secs
                continue
            for name in names:
                row(name)["idle_s"] += secs
            row(names[-1])["self_idle_s"] += secs
            for g in dict.fromkeys(group(n) for n in names):
                groups[g]["idle_s"] += secs

    def top(ops: dict) -> list:
        return sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:TOP_OPS]

    for r in table.values():
        r["ops"] = top(r["ops"])
        r["sites"] = [[op, site, v] for (op, site), v in top(r["sites"])]
    return {
        "spans": table,
        "groups": groups,
        "device_s": device_s,
        "device_events": n_device,
        "idle_s": idle_s,
        "clock_lead_s": lead * 1e-6,
        "unattributed": {"device_s": loose["device_s"], "no_launch_s": loose["no_launch_s"],
                         "ops": top(loose["ops"]), "idle_s": loose_idle,
                         "host": top(doing)},
    }


def read_spans(path: str) -> dict:
    """``summarize_spans`` of a chrome trace file."""
    with open(path) as f:
        return summarize_spans(json.load(f).get("traceEvents", []))


def summary(record: dict, kind: str) -> dict | None:
    """The spans' summary of a traced run of ``kind`` whose trace holds the
    card's work; None where the run was not traced, the trace was taken
    without the spans' summary or on no card."""
    trace = record.get("trace")
    if record.get("kind") != kind or not trace or not record.get("trace_steps"):
        return None
    found = trace.get("spans")
    return found if found and found["device_events"] else None
