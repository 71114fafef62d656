"""step_mfu: the whole step's share of the card's peak, in percent: the
profiled window's frames per second times the seconds a frame would take at
peak, its network FLOP at the bfloat16 rate plus the resize's float32 FLOP
and the tail kernels' float32 operations at the float32 rate."""

from portbench.harness import bounds


def read(t):
    p, w = t["profile"], t["work"]
    at_peak = (w["network_flop"] / bounds.BF16_FLOPS
               + (w["resize_flop"] + w["tail_ops"]) / bounds.FP32_FLOPS)
    return 100.0 * p["frames"] / p["window_s"] * at_peak if at_peak > 0 else None
