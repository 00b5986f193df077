"""Decode: the wall time of the `decode_placements` spans
(backend.decode_placements) a cycle of the window, in ms."""


def read(r):
    if not r.cycles:
        return None
    us = sum(ev["dur"] for ev in r.spans if ev["name"] == "decode_placements")
    return us / 1e3 / r.cycles
