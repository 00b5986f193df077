"""Stream, the batch: the wall time of the `stream_route` spans (the
residency check, the batch's columns, the signature, group and policy
remaps, a statics delta's preparation) and the `stream_pack` spans (the pod
rows on the host, padded to the bucket) a cycle of the window, in ms. A
program without the spans reads nothing."""

SPANS = ("stream_route", "stream_pack")


def read(r):
    spans = [ev for ev in r.spans if ev["name"] in SPANS]
    if not r.cycles or not spans:
        return None
    return sum(ev["dur"] for ev in spans) / 1e3 / r.cycles
