"""Stream, the fold-back: the wall time of the `stream_foldback` spans (the
cycle's binds folded into delta.IncrementalCluster, its journal drained or
rolled back, the WAL's bind and emit records) a cycle of the window, in
ms. A program without the span reads nothing."""

SPANS = ("stream_foldback",)


def read(r):
    spans = [ev for ev in r.spans if ev["name"] in SPANS]
    if not r.cycles or not spans:
        return None
    return sum(ev["dur"] for ev in spans) / 1e3 / r.cycles
