"""device: the share of the traced window in which no operation ran on the
card, in %: 100 * (1 - busy / window), busy the union of every kernel,
copy and fill over the window (device trace)."""


def read(r):
    if r.device is None or r.device.window_s() <= 0 or \
            r.device.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - r.device.busy_s() / r.device.window_s())
