"""Resident scan: the CUDA-event time of the window's `device_dispatch`
spans (upload of the pod rows, the scan's graph replays, the fetch of the
choices) over the pods they decided, in µs."""


def read(r):
    spans = [ev for ev in r.spans if ev["name"] == "device_dispatch"
             and "device_us" in ev.get("args", {})]
    pods = sum(ev["args"].get("pods", 0) for ev in spans)
    if not pods:
        return None
    return sum(ev["args"]["device_us"] for ev in spans) / pods
