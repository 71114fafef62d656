"""networks_mfu: the networks stage's share of its peak, in percent: the
seconds a frame of the stage would take at peak, its network FLOP at the
bfloat16 rate plus the resize's float32 FLOP at the float32 rate, over its
device seconds a frame (``networks_ms``, the harness's CUDA events around
``_batch_segment`` and ``_batch_disparity``). None where no seeded network
ran."""

from portbench.harness import bounds


def read(t):
    w, networks_ms = t["work"], t["stages"]["networks_ms"]
    if t["networks"] != "seeded" or w["network_flop"] <= 0 or networks_ms <= 0:
        return None
    at_peak = w["network_flop"] / bounds.BF16_FLOPS + w["resize_flop"] / bounds.FP32_FLOPS
    return 100.0 * at_peak / (networks_ms * 1e-3)
