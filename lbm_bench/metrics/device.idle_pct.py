"""device.idle_pct: the share of the traced chunk's wall time in which no
kernel ran on the device, in %."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["wall_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
