"""What a traced run reads: the program's flight-recorder spans over the
window, and a torch.profiler stretch of a few cycles inside it.

The spans are the program's own (`tpusim_torch/obs/recorder.py`): a device
span carries its CUDA-event time in `args.device_us` once the recorder has
resolved it. The stretch records device activity alone, so the host runs
its cycles at their own pace; it opens and closes with a marker launched on
an idle card, so its first and last device operations bound it. From it:
the device's busy time (the union of the intervals in which a kernel, copy
or fill ran), the operations by time, and the idle gaps, grouped by what
the card waited for: the next operation of a run of kernels (a gap under
10 µs, a launch's latency) or, for longer gaps, the operation the host
launched next.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

SHORT_GAP_US = 10.0


def recorder_spans(rec) -> List[dict]:
    """The recorder's complete events, device times resolved."""
    rec.resolve_device_times()
    return [ev for ev in list(rec.events) if ev.get("ph") == "X"]


def _device_op(ev) -> bool:
    return ev.get("ph") == "X" and ev.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float, str]]
           ) -> List[Tuple[float, float, str]]:
    """Merged busy intervals, each with the name of the operation that
    opened it."""
    out: List[Tuple[float, float, str]] = []
    for a, b, name in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b, out[-1][2])
        else:
            out.append((a, b, name))
    return out


def _short(name: str) -> str:
    """A kernel's name without its template arguments."""
    return name.split("<", 1)[0].strip()


def read_profile(events: List[dict]) -> Optional[dict]:
    """busy_s, window_s, the device operations by time and the idle gaps,
    from a profiler's Chrome trace events (ts and dur in µs). None where
    the trace holds no device operation."""
    dev = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"])
           for ev in events if _device_op(ev)]
    if not dev:
        return None
    busy = _union(dev)
    w0, w1 = busy[0][0], busy[-1][1]
    ops: Dict[str, float] = {}
    for a, b, name in dev:
        ops[name] = ops.get(name, 0.0) + (b - a)
    idle: Dict[str, float] = {}
    for (_a, prev_end, _n), (start, _b, name) in zip(busy, busy[1:]):
        gap = start - prev_end
        label = ("between kernels (gap < 10 us)" if gap < SHORT_GAP_US
                 else "host, before " + _short(name))
        idle[label] = idle.get(label, 0.0) + gap
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(b - a for a, b, _n in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[name, us * 1e-6] for name, us in top],
        "idle_gaps": [[name, us * 1e-6] for name, us in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        "kernels": sum(1 for ev in events if ev.get("ph") == "X"
                       and ev.get("cat") == "kernel"),
    }
