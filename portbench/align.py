"""A profiled stretch on the program's own clock: each idle gap of the card
named by the host span it fell in, and the kernels each `device_dispatch`
span launched.

The program's flight recorder (`tpusim_torch/obs/recorder.py`) and
torch.profiler keep two clocks. `FlightRecorder.sync_device_clock` launches
a one-element fill and waits for it (a profiler session's first launch can
start half a millisecond late), then eight times reads the recorder's clock
on an idle card and launches the fill again, and pins the readings as an
anchor. Opened with it, a stretch's device operations begin with those
nine fills, and

    offset = max over the eight (reading - the fill's start)

maps the profiler's clock onto the recorder's: the pair with the fastest
launch, whose latency is least (a launch under the profiler on an idle H100
starts some 26-78 µs after it, by single launches). Here the recorder's
spans are moved onto the profiler's clock (span time - offset), so that
every length is still a difference of two of the profiler's own readings.

- `split_gaps`: `trace.read_profile`'s idle gaps, each gap of 10 µs or more
  cut at the boundaries of the spans: a piece inside a span reads
  "in <innermost span>", a piece no span covers keeps "host, before <op>"
  (the harness between cycles, or program code without a span), a shorter
  gap "between kernels". The gaps' total, busy_s and window_s are
  read_profile's.
- `dispatch_kernels`: the kernels whose launch (`cudaLaunchKernel`,
  `cudaGraphLaunch`, matched by the profiler's correlation id) the host made
  inside a `device_dispatch` span, and the pods those spans decided; with no
  runtime events in the trace, the kernels whose start falls inside one.
- `drift_us`: the fills' latency read at the far end of the stretch, from
  a second clock sync that closes it, through the first's offset: a few
  µs where the two clocks agree all through the stretch.

    python3 portbench/align.py --workload <name> --seed <n>

runs a cell's set-up and warm-up as `run.py` does, a 15 s window of cycles
with the recorder installed and the cycles 4-9 profiled between two clock
syncs, then eight 10 s blocks with the recorder off and
on in turn (the cost of tracing), and prints one JSON object: the labelled
gaps and each span's wall in the stretch, the kernel counts, the drift, the
per-layer readers over the window and each block's rate and percentiles.
"""

from __future__ import annotations

import bisect
import os
import statistics
import sys
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench.trace import (  # noqa: E402
    SHORT_GAP_US, _device_op, _short, _union)

ANCHOR, END = "device_sync_us", "device_sync_end_us"
LAUNCHES = ("cuda_runtime", "cuda_driver")
WINDOW_S = 15.0          # the traced window of the measuring run
BLOCKS, BLOCK_S = 8, 10.0  # then blocks with the recorder off, on, on, off


def _device(events) -> List[Tuple[float, float, str]]:
    return [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"])
            for ev in events if _device_op(ev)]


def _starts(events: List[dict]) -> List[float]:
    return sorted(a for a, _b, _n in _device(events))


def offset_us(events: List[dict], readings: List[float]) -> Optional[float]:
    """Recorder time less profiler time, from a clock sync's readings that
    opened the stretch; None where the trace lacks its fills."""
    fills = _starts(events)[1:1 + len(readings)]
    if not readings or len(fills) < len(readings):
        return None
    return max(r - t for r, t in zip(readings, fills))


def _on_profiler_clock(spans: List[dict], offset: float, lo: float,
                       hi: float) -> List[Tuple[float, float, str]]:
    """The spans that overlap [lo, hi] of the profiler's clock, moved onto
    it, ordered by start."""
    out = []
    for ev in spans:
        a = float(ev["ts"]) - offset
        b = a + float(ev["dur"])
        if b > lo and a < hi:
            out.append((a, b, ev["name"]))
    return sorted(out)


def _innermost(cover: List[Tuple[float, float, str]]) -> str:
    """The covering span that opened last (the shortest of those)."""
    return max(cover, key=lambda s: (s[0], -(s[1] - s[0])))[2]


def split_gaps(events: List[dict], spans: List[dict], offset: float
               ) -> Optional[dict]:
    """busy_s, window_s, the idle total and every idle label with its
    seconds, the gaps cut at the spans' boundaries (module docstring)."""
    dev = _device(events)
    if not dev:
        return None
    busy = _union(dev)
    w0, w1 = busy[0][0], busy[-1][1]
    host = _on_profiler_clock(spans, offset, w0, w1)
    starts = [a for a, _b, _n in host]
    idle: Dict[str, float] = {}
    walls: Dict[str, float] = {}
    for a, b, name in host:
        walls[name] = walls.get(name, 0.0) + min(b, w1) - max(a, w0)

    def add(label: str, us: float) -> None:
        idle[label] = idle.get(label, 0.0) + us

    for (_a, g0, _n), (g1, _b, name) in zip(busy, busy[1:]):
        if g1 - g0 < SHORT_GAP_US:
            add("between kernels (gap < 10 us)", g1 - g0)
            continue
        near = [s for s in host[:bisect.bisect_left(starts, g1)] if s[1] > g0]
        cuts = sorted({g0, g1} | {t for a, b, _n in near for t in (a, b)
                                   if g0 < t < g1})
        for lo, hi in zip(cuts, cuts[1:]):
            cover = [s for s in near if s[0] <= lo and s[1] >= hi]
            add("in " + _innermost(cover) if cover
                else "host, before " + _short(name), hi - lo)
    return {"busy_s": sum(b - a for a, b, _n in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "idle_s": sum(idle.values()) * 1e-6,
            "idle_gaps": [[label, us * 1e-6] for label, us in
                          sorted(idle.items(), key=lambda kv: -kv[1])],
            "span_walls": [[name, us * 1e-6] for name, us in
                           sorted(walls.items(), key=lambda kv: -kv[1])]}


def dispatch_kernels(events: List[dict], spans: List[dict], offset: float
                     ) -> Optional[dict]:
    """The kernels the `device_dispatch` spans launched and the pods they
    decided, over the spans inside the stretch; None where there are
    none."""
    dev = _device(events)
    if not dev:
        return None
    w0 = min(a for a, _b, _n in dev)
    w1 = max(b for _a, b, _n in dev)
    dispatch = [s for s in spans if s["name"] == "device_dispatch"
                and float(s["ts"]) - offset >= w0
                and float(s["ts"]) + float(s["dur"]) - offset <= w1]
    if not dispatch:
        return None
    windows = sorted((float(s["ts"]) - offset,
                      float(s["ts"]) + float(s["dur"]) - offset)
                     for s in dispatch)
    starts = [a for a, _b in windows]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= windows[i][1]

    launch = {ev["args"]["correlation"]: float(ev["ts"]) for ev in events
              if ev.get("ph") == "X" and ev.get("cat") in LAUNCHES
              and "correlation" in ev.get("args", {})}
    kernels = [ev for ev in events
               if ev.get("ph") == "X" and ev.get("cat") == "kernel"]
    if launch:
        by = "launch"
        n = sum(1 for ev in kernels
                if inside(launch.get(ev.get("args", {}).get("correlation"),
                                     float("-inf"))))
    else:
        by = "start"
        n = sum(1 for ev in kernels if inside(float(ev["ts"])))
    return {"kernels": n, "pods": sum(s["args"].get("pods", 0)
                                      for s in dispatch),
            "spans": len(dispatch), "attributed_by": by,
            "kernels_in_stretch": len(kernels),
            "wall_us": sum(float(s["dur"]) for s in dispatch),
            "device_us": sum(s["args"].get("device_us", 0.0)
                             for s in dispatch)}


def drift_us(events: List[dict], offset: float, readings: List[float]
             ) -> Optional[float]:
    """The alignment's error at the far end of the stretch, closed by a
    second clock sync: the median over its readings of each one's nearest
    device start on the recorder's clock less the reading (a fill's
    latency, a few µs where the clocks still agree; a fill the profiler
    lost moves one reading alone)."""
    starts = _starts(events)
    if not starts or not readings:
        return None
    return statistics.median(min((t + offset - r for t in starts), key=abs)
                             for r in readings)


# -- the measuring run ---------------------------------------------------

def measure(workload: str, seed: int, say) -> dict:
    import time

    import torch

    from portbench import generator, run
    from portbench.program import Twin
    from portbench.trace import read_profile, recorder_spans
    from tpusim_torch.obs import recorder

    bench = run.load_bench()
    _cell, config, mix = run.load_cell(workload, bench)
    inputs = generator.make_inputs(config, seed)
    twin = Twin(config, inputs, "cuda")
    traffic = generator.Traffic(config, mix, inputs.nodes, seed,
                                {p.name: 1 for p in inputs.population})

    def cycle(walls=None) -> int:
        c = traffic.next_cycle()
        events, pods = twin.prepare(c)
        t0 = time.perf_counter()
        placements = twin.run_cycle(events, pods)
        if walls is not None:
            walls.append(time.perf_counter() - t0)
        traffic.note_bound(twin.note(placements))
        return len(placements)

    for _ in range(mix["warmup_cycles"]):
        cycle()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]):
        cycle()
    torch.cuda.synchronize()

    # the window: the recorder on, the cycles 4-9 profiled as run.py does
    restages_before = dict(twin.session.restage_counts)
    rec = recorder.install(recorder.FlightRecorder())
    walls: List[float] = []
    last = run.PROFILE_AFTER + run.PROFILED_CYCLES - 1
    deadline = time.perf_counter() + WINDOW_S
    while len(walls) <= last or time.perf_counter() < deadline:
        n = len(walls)
        if n == run.PROFILE_AFTER:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            rec.sync_device_clock("cuda")
        cycle(walls)
        if n == last:
            rec.sync_device_clock("cuda", END)
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
    torch.cuda.synchronize()
    events = run._profile_events(prof)
    spans = recorder_spans(rec)
    recorder.uninstall()
    off = offset_us(events, rec.anchors[ANCHOR])
    restages = {k: v - restages_before.get(k, 0)
                for k, v in twin.session.restage_counts.items()}
    r = run.Readings(spans=spans, cycles=len(walls), cycle_walls_s=walls,
                     restages=restages, profile=read_profile(events))
    readers = {m["name"]: run.load_reader(m["name"])(r)
               for m in bench["per_layer"]
               if workload in m.get("workloads", [workload])}
    every = [ev for ev in spans if ev["name"] == "device_dispatch"]
    out = {"cycles": len(walls), "offset_us": off,
           "dispatch_window_mean_us": {
               "wall": sum(float(ev["dur"]) for ev in every) / len(every),
               "device": sum(ev["args"]["device_us"] for ev in every)
               / len(every)},
           "drift_us": drift_us(events, off, rec.anchors[END]),
           "runtime_events": sum(1 for ev in events
                                 if ev.get("cat") in LAUNCHES),
           "read_profile": r.profile,
           "aligned": split_gaps(events, spans, off),
           "dispatch": dispatch_kernels(events, spans, off),
           "readers": readers}

    # the cost of tracing: blocks with the recorder off and on in turn
    out["blocks"] = []
    for b in range(BLOCKS):
        on = b % 4 in (1, 2)
        if on:
            recorder.install(recorder.FlightRecorder())
        walls, decided = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < BLOCK_S:
            decided += cycle(walls)
        window = time.perf_counter() - t0
        recorder.uninstall()
        out["blocks"].append({"recorder": on,
                              "decisions_per_s": decided / window,
                              "cycle_p50_ms": run.percentile(walls, 50) * 1e3,
                              "cycle_p95_ms": run.percentile(walls, 95) * 1e3,
                              "cycles": len(walls)})
        say(f"align: block {b} recorder {on}: {out['blocks'][-1]}")
    out["card"] = run._card_power_limit()
    return out


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from portbench import run

    run._pin_environment()
    import torch

    if not torch.cuda.is_available():
        print("align: no CUDA device", file=sys.stderr)
        return 3
    out = measure(args.workload, args.seed,
                  lambda line: print(line, file=sys.stderr, flush=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
