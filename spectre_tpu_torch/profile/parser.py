"""Profiler trace post-processor (port of spectre_tpu/profile/parser.py).

Reads a Kineto chrome trace (what ``torch.profiler`` exports, ``*.trace.json``
or ``.json.gz``; ``trace_step`` writes one) and aggregates its complete
events per name into a table with the JAX package's chainable API and
columns:

    ProfilerParser(trace_dir)
        .remove_idle()
        .filter_name("gemm|gather")
        .add_percentages()
        .round()
        .sort_by_device()
        .show()
        .to_csv("plots/encoder_layer.csv")

Columns: name, calls, host_total_ms, device_total_ms, avg_device_ms (and
device_pct after ``add_percentages``). An event is the card's when its
category is one of ``DEVICE_CATEGORIES`` (kernels, copies and fills on a
GPU lane); the annotations Kineto draws over a span of the card's timeline
(``gpu_user_annotation``) are neither host nor device work and are dropped;
every other complete event is the host's. The JAX package names TPU lanes
instead. The table is plain Python rows, so that nothing but the standard
library is needed; ``to_pandas`` imports pandas when asked.
"""

from __future__ import annotations

import csv
import glob
import gzip
import json
import os
import re

COLUMNS = ("name", "calls", "host_total_ms", "device_total_ms", "avg_device_ms")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_DROPPED_CATEGORIES = ("gpu_user_annotation",)


def _find_trace_file(path: str) -> str:
    if os.path.isfile(path):
        return path
    matches = sorted(
        glob.glob(os.path.join(path, "**", "*.trace.json.gz"), recursive=True)
        + glob.glob(os.path.join(path, "**", "*.trace.json"), recursive=True),
        key=os.path.getmtime,
    )
    if not matches:
        raise FileNotFoundError(f"no *.trace.json(.gz) under {path}")
    return matches[-1]


def _load_events(trace_file: str) -> dict:
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        return json.load(f)


def _table(events: list) -> list[dict]:
    """One row per event name, host and device time apart, names sorted."""
    rows: dict[tuple[str, bool], list[float]] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or e.get("cat") in _DROPPED_CATEGORIES:
            continue
        key = (e.get("name", "?"), e.get("cat") in DEVICE_CATEGORIES)
        rows.setdefault(key, []).append(e["dur"] / 1000.0)  # us -> ms
    table = []
    for n in sorted({n for (n, _) in rows}):
        host, dev = rows.get((n, False), []), rows.get((n, True), [])
        table.append({"name": n, "calls": max(len(host), len(dev)),
                      "host_total_ms": float(sum(host)), "device_total_ms": float(sum(dev)),
                      "avg_device_ms": (sum(dev) / len(dev)) if dev else 0.0})
    return table


class ProfilerParser:
    """Aggregate a ``torch.profiler`` trace into a per-op table of plain rows.

    ``trace`` is a trace file, a directory holding one (the newest is read),
    or rows as ``rows`` returns them."""

    def __init__(self, trace: str | list[dict], columns: tuple[str, ...] = COLUMNS):
        if isinstance(trace, list):
            self._rows, self._columns = trace, tuple(columns)
            return
        data = _load_events(_find_trace_file(trace))
        self._rows, self._columns = _table(data.get("traceEvents", [])), COLUMNS

    def _with(self, rows: list[dict], columns: tuple[str, ...] | None = None) -> "ProfilerParser":
        return ProfilerParser(rows, columns or self._columns)

    @property
    def rows(self) -> list[dict]:
        """The table, a copy of each row."""
        return [dict(r) for r in self._rows]

    # -- chainable transforms (the JAX package's surface) --------------------

    def remove_idle(self) -> "ProfilerParser":
        return self._with([r for r in self._rows
                           if not re.search("idle|Idle|unknown", r["name"])])

    def filter_name(self, pattern: str) -> "ProfilerParser":
        return self._with([r for r in self._rows if re.search(pattern, r["name"])])

    def add_percentages(self) -> "ProfilerParser":
        total = sum(r["device_total_ms"] for r in self._rows)
        rows = [dict(r, device_pct=100.0 * r["device_total_ms"] / total if total else 0.0)
                for r in self._rows]
        columns = self._columns + (() if "device_pct" in self._columns else ("device_pct",))
        return self._with(rows, columns)

    def round(self, digits: int = 3) -> "ProfilerParser":
        return self._with([{k: round(v, digits) if isinstance(v, float) else v
                            for k, v in r.items()} for r in self._rows])

    def sort_by_device(self) -> "ProfilerParser":
        return self._with(sorted(self._rows, key=lambda r: -r["device_total_ms"]))

    def sort_by_host(self) -> "ProfilerParser":
        return self._with(sorted(self._rows, key=lambda r: -r["host_total_ms"]))

    def head(self, n: int = 20) -> "ProfilerParser":
        return self._with(self._rows[:n])

    # -- sinks ---------------------------------------------------------------

    def show(self, name_width: int = 60) -> "ProfilerParser":
        """Print the table, names cut to ``name_width`` characters."""
        def cell(v):
            return f"{v:.3f}" if isinstance(v, float) else str(v)

        cells = [[cell(r[c]) for c in self._columns] for r in self._rows]
        for row in cells:
            row[0] = row[0][:name_width]
        widths = [max([len(c)] + [len(row[i]) for row in cells])
                  for i, c in enumerate(self._columns)]
        print("  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                        for i, (c, w) in enumerate(zip(self._columns, widths))))
        for row in cells:
            print("  ".join(v.ljust(w) if i == 0 else v.rjust(w)
                            for i, (v, w) in enumerate(zip(row, widths))))
        return self

    def to_pandas(self):
        try:
            import pandas as pd
        except ImportError:
            raise ImportError("ProfilerParser.to_pandas needs pandas, which is not installed; "
                              "rows, show and to_csv work without it") from None
        return pd.DataFrame(self.rows, columns=list(self._columns))

    def to_csv(self, path: str) -> "ProfilerParser":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._columns)
            writer.writeheader()
            writer.writerows(self._rows)
        return self
