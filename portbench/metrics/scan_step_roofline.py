"""Scan step kernels: the least time one step of the resident scan needs,
its bytes (roofline.step_bytes, from the shapes of the resident statics,
carry and pod row) over the card's published memory bandwidth, as a share of
the measured device time of a step (the `device_dispatch` spans' CUDA-event
time over their pods), in %. The step is integer work, so its bytes bound
it; the share is against the published peak at full power, and the run
prints the card's power limit beside it."""


def read(r):
    spans = [ev for ev in r.spans if ev["name"] == "device_dispatch"
             and "device_us" in ev.get("args", {})]
    pods = sum(ev["args"].get("pods", 0) for ev in spans)
    if not pods or not r.step_bytes or not r.peak:
        return None
    step_s = sum(ev["args"]["device_us"] for ev in spans) * 1e-6 / pods
    least_s = r.step_bytes / r.peak["hbm_bytes_per_s"]
    return 100.0 * least_s / step_s
