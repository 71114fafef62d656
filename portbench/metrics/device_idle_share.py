"""device_idle_share: the percentage of the profiled window of real calls in
which no kernel, copy or set ran on the device."""


def read(t):
    p = t["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p["window_s"] > 0 else None
