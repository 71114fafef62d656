"""PyTorch port against the JAX package: FCN-8s logits and Monodepth
disparity from the same numpy-seeded flax parameters, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu.models.monodepth import flip_average_postprocess as jax_flip_average
from semantic_depth_tpu_torch.models import FCN8s, Monodepth, flip_average_postprocess
from semantic_depth_tpu_torch.models.from_flax import load_flax, state_dict_from_flax

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

_FCN_SMALL = dict(width_mult=0.0625, fc_channels=32)


def _frames(seed, b=2, h=128, w=256):
    return np.random.default_rng(seed).uniform(0, 255, size=(b, h, w, 3)).astype(np.float32)


def _fcn_params(x):
    return numpy_params(JaxFCN8s(num_classes=3, **_FCN_SMALL), x, seed=0)


def test_fcn8s_logits_match_jax_fp32():
    x = _frames(0)
    params = _fcn_params(x)
    want = np.asarray(JaxFCN8s(num_classes=3, **_FCN_SMALL).apply(params, jnp.asarray(x)))
    net = load_flax(FCN8s(num_classes=3, **_FCN_SMALL), params).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 128, 256, 3)
    assert np.abs(want).max() > 0.3  # the check below is not vacuous
    # float32 convolutions summed in other orders: ~1e-6 relative
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_fcn8s_logits_match_jax_bf16():
    x = _frames(1, b=1)
    params = _fcn_params(x)
    jnet = JaxFCN8s(num_classes=3, compute_dtype=jnp.bfloat16, **_FCN_SMALL)
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    net = load_flax(FCN8s(num_classes=3, compute_dtype=torch.bfloat16, **_FCN_SMALL), params)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    # bf16 keeps 8 bits; the two frameworks round at different places
    # (accumulators, bias adds), so allow a few bf16 ulps of the logit scale
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * scale)


def test_transposed_conv_mapping_pins_padding_and_orientation():
    """A single upscore layer with an asymmetric kernel: any flip or
    transpose slip in ``from_flax`` or the (1, 1, 4) paddings shows here."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    for k, s, pad in ((4, 2, 1), (16, 8, 4)):
        x = rng.normal(size=(1, 5, 7, 3)).astype(np.float32)
        layer = fnn.ConvTranspose(3, (k, k), strides=(s, s), padding="SAME",
                                  transpose_kernel=True)
        params = numpy_params(layer, x, seed=k)
        want = np.asarray(layer.apply(params, jnp.asarray(x)))
        tl = torch.nn.ConvTranspose2d(3, 3, k, stride=s, padding=pad)
        sd = state_dict_from_flax({"params": {"up": params["params"]}})
        tl.load_state_dict({"weight": sd["up.weight"], "bias": sd["up.bias"]})
        with torch.no_grad():
            got = tl(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, 5 * s, 7 * s, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s2d_opt", [False, True])
def test_monodepth_disp_left_matches_jax(s2d_opt):
    """Against the JAX plain path and against its default (the s2d rewrite,
    pinned equal to the plain path in the JAX package)."""
    x = _frames(3) / 255.0
    jnet = JaxMonodepth(encoder="vgg", width_mult=0.0625, s2d_opt=s2d_opt)
    params = numpy_params(jnet, x, seed=1)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), method=jnet.disp_left))
    net = load_flax(Monodepth("vgg", width_mult=0.0625), params).eval()
    with torch.no_grad():
        got = net.disp_left(torch.from_numpy(x)).numpy()
        pyramid = net(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 128, 256)
    assert [tuple(d.shape) for d in pyramid] == [
        (2, 128 >> i, 256 >> i, 2) for i in range(4)
    ]
    # float32 summation order only (disparities are ~0.15)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_monodepth_bf16_close_to_jax():
    x = _frames(4, b=1) / 255.0
    jnet = JaxMonodepth(encoder="vgg", width_mult=0.0625, compute_dtype=jnp.bfloat16)
    params = numpy_params(jnet, x, seed=2)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), method=jnet.disp_left))
    net = load_flax(Monodepth("vgg", compute_dtype=torch.bfloat16, width_mult=0.0625), params)
    with torch.no_grad():
        got = net.eval().disp_left(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    # disparity lies in (0, 0.3); bf16 rounding differs between frameworks
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError):
        FCN8s(input_s2d=True)
    with pytest.raises(NotImplementedError):
        Monodepth(encoder="resnet50")
    with pytest.raises(NotImplementedError):
        Monodepth(input_s2d=True)


def test_flip_average_postprocess_matches_jax():
    rng = np.random.default_rng(5)
    disp = rng.uniform(0, 0.3, size=(3, 2, 16, 40)).astype(np.float32)
    got = flip_average_postprocess(torch.from_numpy(disp)).numpy()
    for i in range(3):
        want = np.asarray(jax_flip_average(jnp.asarray(disp[i])))
        # same elementwise float32 ops; the ramp is exactly i / (w - 1)
        np.testing.assert_array_equal(got[i], want)
