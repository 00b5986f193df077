"""Device: the share of the profiled stretch of the window (six cycles under
torch.profiler, device activity alone, between two markers on an idle card)
in which no kernel, copy or fill ran on the card, in %."""


def read(r):
    p = r.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
