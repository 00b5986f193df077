"""Stream: a cycle's wall time (the harness's clock around
apply_events and schedule) less its commit, dispatch and decode spans: the
event fold, the batch's columns and routing, packing and the fold-back of
the binds, a cycle of the window, in ms."""

SPANS = ("stream_commit", "statics_commit", "device_dispatch",
         "decode_placements")


def read(r):
    if not r.cycles:
        return None
    inner_us = sum(ev["dur"] for ev in r.spans if ev["name"] in SPANS)
    return (sum(r.cycle_walls_s) * 1e3 - inner_us / 1e3) / r.cycles
