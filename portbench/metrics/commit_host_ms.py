"""Commit, its host side: the wall time of the `commit_gather` spans (the
lock lanes a restage would stage, the journal drained, the touched rows
gathered) a cycle of the window, in ms; `commit_ms` reads the device side
that follows. A program without the span reads nothing."""

SPANS = ("commit_gather",)


def read(r):
    spans = [ev for ev in r.spans if ev["name"] in SPANS]
    if not r.cycles or not spans:
        return None
    return sum(ev["dur"] for ev in spans) / 1e3 / r.cycles
