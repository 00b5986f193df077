"""Scan step kernels: the kernels the card ran in the profiled stretch of
the window (`trace.read_profile`'s count over cycles 4-9 under
torch.profiler, between two markers) over the pods that the stretch's
`device_dispatch` spans decided. The scan's steps launch all but a few of
them; the rest are the commit's, the analytics' and the two markers'. A
cycle's spans follow its `stream_ingest` span, so a program without that
span reads nothing."""

from portbench.run import PROFILE_AFTER, PROFILED_CYCLES


def read(r):
    p = r.profile
    if not p or not p.get("kernels"):
        return None
    last = min(PROFILE_AFTER + PROFILED_CYCLES, r.cycles)
    cycle, pods = -1, 0
    for ev in r.spans:
        if ev["name"] == "stream_ingest":
            cycle += 1
        elif ev["name"] == "device_dispatch" and PROFILE_AFTER <= cycle < last:
            pods += ev.get("args", {}).get("pods", 0)
    if not pods:
        return None
    return p["kernels"] / pods
