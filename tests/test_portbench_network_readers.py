"""The networks layer's readers on hand-built traces: the ResNet-50 cell's
``conv_layout_share``, cuDNN's layout conversions over the networks stage's
device time in the profiled window; the DPT-Large cell's
``attention_roofline``, the attention kernels' share of their FLOP bound,
and ``networks_mfu``, the networks stage's share of its peak."""

import pytest

from portbench.harness import bounds
from portbench.metrics import attention_roofline, conv_layout_share, networks_mfu

NCHW = "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, 1, 1>(...)"
NHWC = "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, 1, 1>(...)"


def _t(kernel_s, networks_ms=2.5, frames=400):
    return dict(profile=dict(kernel_s=kernel_s, frames=frames, busy_s=1.5, window_s=2.0),
                stages=dict(networks_ms=networks_ms, tail_ms=0.3))


def test_conv_layout_share_is_the_conversions_over_the_networks_stage():
    # 400 frames at 2.5 ms a frame: 1 s of networks stage, 0.15 s converting
    t = _t({NCHW: 0.10, NHWC: 0.05,
            "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": 0.60})
    assert conv_layout_share.read(t) == pytest.approx(15.0, rel=1e-12)


def test_conv_layout_share_is_not_moved_by_the_upload_or_the_tail():
    base = {NCHW: 0.10, NHWC: 0.05, "sm90_xmma_gemm": 0.60}
    more = dict(base, **{"Memcpy HtoD (Pageable -> Device)": 0.5, "Memset (Device)": 0.01,
                         "(anonymous namespace)::radius_kernel(float const*)": 0.03,
                         "void at::native::elementwise_kernel<128, 4>": 0.16})
    assert conv_layout_share.read(_t(more)) == conv_layout_share.read(_t(base))


def test_conv_layout_share_reads_zero_without_a_conversion_and_nothing_without_frames():
    assert conv_layout_share.read(_t({"sm90_xmma_gemm": 0.6, "Memset (Device)": 0.1})) == 0.0
    assert conv_layout_share.read(_t({NCHW: 0.1}, frames=0)) is None
    assert conv_layout_share.read(_t({NCHW: 0.1}, networks_ms=0.0)) is None


# --- the DPT-Large cell: attention_roofline, networks_mfu --------------------

# the attention kernel that the card ran for the cell (torch 2.11, H100)
SDPA = ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1"
        "_cga1x1x1_kernel0_0")


def _dpt(kernel_s, frames=400, networks_ms=4.0, networks="seeded", network_flop=1022.6e9,
         resize_flop=4.83e9):
    return dict(profile=dict(kernel_s=kernel_s, frames=frames, busy_s=1.9, window_s=2.0),
                stages=dict(networks_ms=networks_ms, tail_ms=0.3), networks=networks,
                work=dict(network_flop=network_flop, resize_flop=resize_flop, tail_ops=1e8))


def test_attention_flop_a_frame_of_the_dpt_configuration():
    import json

    c = json.loads((attention_roofline.CONFIG).read_text())
    # 513 tokens (16 x 32 patches and the class token), 1024 wide, 24 layers, the flip pair
    assert attention_roofline.attention_flop_per_frame(c) == 4.0 * 513 ** 2 * 1024 * 24 * 2
    c["networks"]["monodepth"]["flip_average"] = False
    assert attention_roofline.attention_flop_per_frame(c) == 4.0 * 513 ** 2 * 1024 * 24


def test_attention_roofline_is_the_window_attention_flop_over_the_sdpa_kernels():
    # 400 frames of 51.74 GFLOP: 20.69 TFLOP, 20.9 ms at the bfloat16 peak;
    # 0.1 s in the attention kernels reads 20.9%
    flop = 4.0 * 513 ** 2 * 1024 * 24 * 2 * 400
    t = _dpt({SDPA: 0.06, "void pytorch_flash::flash_fwd_kernel<...>(Flash_fwd_params)": 0.03,
              "fmha_cutlassF_bf16_aligned_64x128_rf_sm80(...)": 0.01,
              "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64": 0.9,
              "Memcpy HtoD (Pageable -> Device)": 0.5})
    want = 100.0 * flop / bounds.BF16_FLOPS / 0.1
    assert attention_roofline.read(t) == pytest.approx(want, rel=1e-12)
    assert 20.0 < want < 21.5


def test_attention_roofline_reads_nothing_without_an_sdpa_kernel():
    t = _dpt({"sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n": 0.9, NCHW: 0.1})
    assert attention_roofline.read(t) is None
    assert attention_roofline.read(_dpt({})) is None


def test_networks_mfu_is_the_stage_work_at_peak_over_its_span():
    t = _dpt({SDPA: 0.1})
    at_peak = 1022.6e9 / bounds.BF16_FLOPS + 4.83e9 / bounds.FP32_FLOPS
    assert networks_mfu.read(t) == pytest.approx(100.0 * at_peak / 4.0e-3, rel=1e-12)
    assert 25.0 < networks_mfu.read(t) < 28.0
    assert networks_mfu.read(_dpt({}, networks_ms=0.0)) is None


def test_networks_mfu_reads_nothing_without_a_seeded_network():
    assert networks_mfu.read(_dpt({}, networks="scenes", network_flop=0.0)) is None
    assert networks_mfu.read(_dpt({}, network_flop=0.0)) is None
