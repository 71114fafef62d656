"""The networks layer's reader of the ResNet-50 cell on hand-built traces:
``conv_layout_share``, cuDNN's layout conversions over the networks stage's
device time in the profiled window."""

import pytest

from portbench.metrics import conv_layout_share

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
