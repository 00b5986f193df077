"""Stream, the event fold: the wall time of the `stream_ingest` spans
(StreamSession.apply_events folding a cycle's watch events into
delta.IncrementalCluster) a cycle of the window, in ms. A program without
the span reads nothing."""

SPANS = ("stream_ingest",)


def read(r):
    spans = [ev for ev in r.spans if ev["name"] in SPANS]
    if not r.cycles or not spans:
        return None
    return sum(ev["dur"] for ev in spans) / 1e3 / r.cycles
