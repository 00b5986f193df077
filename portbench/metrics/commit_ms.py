"""Commit: the wall time of the `stream_commit` and `statics_commit` spans
(scan.apply_delta_ and scan.apply_statics_delta_ with their host
gathering) a cycle of the window, in ms."""


def read(r):
    if not r.cycles:
        return None
    us = sum(ev["dur"] for ev in r.spans
             if ev["name"] in ("stream_commit", "statics_commit"))
    return us / 1e3 / r.cycles
