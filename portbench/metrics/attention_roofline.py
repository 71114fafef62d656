"""attention_roofline: the attention kernels' share of their roofline, in
percent: the profiled window's frames times the attention FLOP a frame of
the DPT-Large configuration, over the bfloat16 peak, divided by the device
seconds of the kernels that ``F.scaled_dot_product_attention`` launches,
by their names (``SDPA``). Attention is bound by its products, so the
bound is its FLOP: 4 n^2 width a layer and image (Q K^T and the mixing, n
tokens, the class token included), ``layers`` a network, two images a
frame with the flip batch. None where no such kernel ran."""

import json
from pathlib import Path

from portbench.harness import bounds

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "munich-dpt-large-bf16.json"
# the fused kernels of F.scaled_dot_product_attention on the card: cuDNN's,
# which torch 2.11 picks on the H100 for the cell's bfloat16 heads of 64
# (cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_...),
# and the flash and memory-efficient (cutlass) kernels it may pick instead
SDPA = ("flash_fwd", "fmha_cutlass", "cudnn_generated_fort_native_sdpa")


def attention_flop_per_frame(config) -> float:
    """Attention's two products a frame of ``config``'s monodepth slot at
    its input size."""
    net = config["networks"]["monodepth"]
    n = (config["input_height"] // net["patch"]) * (config["input_width"] // net["patch"]) + 1
    images = 2 if net["flip_average"] else 1
    return 4.0 * n * n * net["width"] * net["layers"] * images


def read(t):
    prof = t["profile"]
    spent = sum(s for name, s in prof["kernel_s"].items() if any(k in name for k in SDPA))
    if spent <= 0:
        return None
    flop = attention_flop_per_frame(json.loads(CONFIG.read_text())) * prof["frames"]
    return 100.0 * flop / bounds.BF16_FLOPS / spent
