"""Stream: the twin's restages in the window, all reasons together
(StreamSession.restage_counts; the run prints them by reason). A steady
twin reads 0."""


def read(r):
    if r.restages is None:
        return None
    return float(sum(r.restages.values()))
