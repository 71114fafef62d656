"""kernels_roofline: the sum of K1, K2 and K3's bound ms over the sum of their
device ms in the profiled window, in percent. Each call's bounds come from
the inputs its kernels were given (``harness.bounds``); None when the
window ran none of them."""


def read(t):
    spent = sum(t["kernel_ms"].values())
    return 100.0 * t["bound_ms"] / spent if spent > 0 else None
