"""The port's monodepth training path against the JAX package on the CPU:
the warp sampler, SSIM, the pyramid, the smoothness and the whole loss (with
gradients), one and two Adam steps, init, checkpoints, the stereo loader and
the training CLI.

Sizes are small: monodepth-vgg at width 0.0625 on 128x256 pairs (the vgg
trunk halves seven times, so 128 rows is the least it takes), the loss
functions on 64x128. Every comparison states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu.models import weights as jweights
from semantic_depth_tpu.ops import sampler as jsampler
from semantic_depth_tpu.train import monodepth_trainer as jmt
from semantic_depth_tpu.train import stereo_data as jstereo
from semantic_depth_tpu_torch.cli import monodepth_train as tcli
from semantic_depth_tpu_torch.models import Monodepth
from semantic_depth_tpu_torch.models.from_flax import adam_state_from_optax
from semantic_depth_tpu_torch.ops import sampler as tsampler
from semantic_depth_tpu_torch.train import monodepth_trainer as tmt
from semantic_depth_tpu_torch.train import stereo_data as tstereo

from torch_helpers import flax_flat, numpy_params, port_flat

torch.set_num_threads(2)  # six xdist workers share the machine

_TINY = dict(width_mult=0.0625)
_HW = (128, 256)
_LR = 1e-3  # large enough that a step moves float32 parameters well past their rounding


def _t(x):
    return torch.from_numpy(np.asarray(x)).requires_grad_(True)


def _close(got, want, rtol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=what)


# --- sampler ------------------------------------------------------------------------


@pytest.mark.parametrize("wrap_mode", ["border", "edge"])
def test_bilinear_sample_x_and_its_gradients_match_jax(wrap_mode):
    """Offsets reach 0.6 of the width, so many samples fall past the border
    and beyond the pad; column 0 of each row lands exactly on the lower clip
    bound, where JAX and the port both give each side of the tie half the
    gradient. No element is left out. Values and gradients: rtol 1e-5 of
    the largest."""
    rng = np.random.default_rng(0)
    b, h, w, c = 2, 8, 64, 3
    img = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = rng.uniform(-0.6, 0.6, (b, h, w)).astype(np.float32)
    bound = -1.0 if wrap_mode == "border" else 0.0  # sample_x at the clip's lower bound
    off[:, :, 0] = np.float32(bound / w)  # w is a power of two: exact
    weights = rng.normal(size=(b, h, w, c)).astype(np.float32)

    def jloss(i, o):
        return jnp.sum(jsampler.bilinear_sample_x(i, o, wrap_mode) * weights)

    want = jsampler.bilinear_sample_x(jnp.asarray(img), jnp.asarray(off), wrap_mode)
    gi_want, go_want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(off))
    ti, to = _t(img), _t(off)
    got = tsampler.bilinear_sample_x(ti, to, wrap_mode)
    (got * torch.from_numpy(weights)).sum().backward()
    _close(got.detach(), want, 1e-5, "values")
    _close(ti.grad, gi_want, 1e-5, "d/d img")
    _close(to.grad, go_want, 1e-5, "d/d offset")
    assert np.asarray(go_want)[:, :, 0].any()  # the tie column carries a gradient
    with pytest.raises(ValueError, match="wrap_mode"):
        tsampler.bilinear_sample_x(ti, to, "wrap")


def test_warps_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (1, 16, 32, 3)).astype(np.float32)
    disp = rng.uniform(0, 0.3, (1, 16, 32)).astype(np.float32)
    for tf, jf in ((tsampler.warp_right_to_left, jsampler.warp_right_to_left),
                   (tsampler.warp_left_to_right, jsampler.warp_left_to_right)):
        _close(tf(torch.from_numpy(img), torch.from_numpy(disp)),
               jf(jnp.asarray(img), jnp.asarray(disp)), 1e-6, tf.__name__)


# --- loss pieces --------------------------------------------------------------------


def test_ssim_pyramid_and_smoothness_match_jax():
    """Values rtol 1e-5, gradients rtol 1e-4 of the largest (window sums in
    another order)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    disp = rng.uniform(0, 0.3, (2, 64, 128)).astype(np.float32)

    want = jax.jit(jmt.ssim)(jnp.asarray(x), jnp.asarray(y))
    gx_want = jax.jit(jax.grad(lambda a: jnp.mean(jmt.ssim(a, jnp.asarray(y)))))(jnp.asarray(x))
    tx = _t(x)
    got = tmt.ssim(tx, torch.from_numpy(y))
    got.mean().backward()
    _close(got.detach(), want, 1e-5, "ssim")
    _close(tx.grad, gx_want, 1e-4, "d ssim / dx")

    for g, w in zip(tmt.image_pyramid(torch.from_numpy(x), 4), jmt.image_pyramid(jnp.asarray(x), 4)):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-6, "pyramid")

    want = jmt.disparity_smoothness(jnp.asarray(disp), jnp.asarray(x))
    gd_want = jax.grad(jmt.disparity_smoothness)(jnp.asarray(disp), jnp.asarray(x))
    td = _t(disp)
    got = tmt.disparity_smoothness(td, torch.from_numpy(x))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    _close(td.grad, gd_want, 1e-4, "d smoothness / d disp")


def test_monodepth_loss_and_its_disparity_gradients_match_jax():
    """The 4-scale loss and its three parts: rel 1e-5; the gradients with
    respect to every scale's disparities: rtol 1e-4 of the largest."""
    rng = np.random.default_rng(3)
    h, w = 64, 128
    left = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2)
    disps = [(0.3 / (1 + np.exp(-rng.normal(size=(2, h >> i, w >> i, 2))))).astype(np.float32)
             for i in range(4)]
    jcfg, tcfg = jmt.MonodepthTrainConfig(), tmt.MonodepthTrainConfig()

    def jloss(ds):
        return jmt.monodepth_loss(ds, jnp.asarray(left), jnp.asarray(right), jcfg)

    (want, want_aux), grads_want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(d) for d in disps])
    tds = [_t(d) for d in disps]
    got, aux = tmt.monodepth_loss(tds, torch.from_numpy(left), torch.from_numpy(right), tcfg)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    assert aux.keys() == want_aux.keys()
    for k in aux:
        assert aux[k].item() == pytest.approx(float(want_aux[k]), rel=1e-5), k
    for i, (td, gw) in enumerate(zip(tds, grads_want)):
        _close(td.grad, gw, 1e-4, f"d loss / d disps[{i}]")


# --- train steps against the JAX trainer --------------------------------------------


def _stereo_pair(seed, n=1):
    """A smoothed random base and its 4-px shift."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (n, *_HW, 3)).astype(np.float32)
    for _ in range(2):
        base[:, :, 1:-1] = (base[:, :, :-2] + base[:, :, 1:-1] + base[:, :, 2:]) / 3
        base[:, 1:-1] = (base[:, :-2] + base[:, 1:-1] + base[:, 2:]) / 3
    return base, np.roll(base, -4, axis=2)


@pytest.fixture(scope="module")
def jax_steps():
    left, right = _stereo_pair(4, n=2)
    params = numpy_params(JaxMonodepth(encoder="vgg", **_TINY), left[:1], seed=5)
    jt = jmt.MonodepthTrainer(jmt.MonodepthTrainConfig(learning_rate=_LR),
                              model=JaxMonodepth(encoder="vgg", **_TINY), init_params=params)
    states, metrics, opt_states = [jax.tree.map(np.asarray, params)], [], []
    for _ in range(2):
        metrics.append(jt.train_batch(jnp.asarray(left), jnp.asarray(right)))
        states.append(jax.tree.map(np.asarray, jt.params))
        opt_states.append(jax.tree.map(np.asarray, jt.opt_state))
    return dict(left=left, right=right, states=states, metrics=metrics, opt_states=opt_states)


def _check_step(tt, got_m, want_m, before, after, grads_want):
    """Loss and its parts rel 1e-5; the gradients rtol 1e-4, atol 1e-4 of
    the layer's largest; the post-step parameters where |g| > 1e-4 max|g|
    (elsewhere a float32-noise gradient may step Adam either way) within
    2e-6, 0.2% of lr."""
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        assert got_m[k] == pytest.approx(want_m[k], rel=1e-5), k
    grads, params = port_flat(tt.model, grads=True), port_flat(tt.model)
    for name, g_want in grads_want.items():
        scale = np.abs(g_want).max()
        np.testing.assert_allclose(grads[name], g_want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
        big = np.abs(g_want) > 1e-4 * scale
        np.testing.assert_allclose(params[name][big], after[name][big], rtol=0, atol=2e-6,
                                   err_msg=name)
        assert not np.array_equal(after[name][big], before[name][big]), name


def _port_trainer(params):
    return tmt.MonodepthTrainer(tmt.MonodepthTrainConfig(learning_rate=_LR),
                                model=Monodepth("vgg", **_TINY), init_params=params,
                                device="cpu")


def test_monodepth_train_step_matches_jax(jax_steps):
    js = jax_steps
    tt = _port_trainer(js["states"][0])
    m = tt.train_batch(js["left"], js["right"])
    mu = flax_flat(js["opt_states"][0][0].mu)  # (1 - b1) * g after step 1
    _check_step(tt, m, js["metrics"][0], flax_flat(js["states"][0]), flax_flat(js["states"][1]),
                {k: v / np.float32(0.1) for k, v in mu.items()})


def test_monodepth_second_step_from_the_jax_adam_state(jax_steps):
    js = jax_steps
    tt = _port_trainer(js["states"][1])
    sd = tt.optimizer.state_dict()
    sd["state"] = adam_state_from_optax(js["opt_states"][0], tt.model)
    tt.optimizer.load_state_dict(sd)
    m = tt.train_batch(js["left"], js["right"])
    mu1, mu2 = flax_flat(js["opt_states"][0][0].mu), flax_flat(js["opt_states"][1][0].mu)
    _check_step(tt, m, js["metrics"][1], flax_flat(js["states"][1]), flax_flat(js["states"][2]),
                {k: (mu2[k] - np.float32(0.9) * mu1[k]) / np.float32(0.1) for k in mu1})


def test_monodepth_init_moments_match_flax_per_layer():
    """Each kernel's std against flax's init of the same layer: within 5%,
    or within 4 sigma of the two std estimates where a layer is too small
    for 5% (the 2-channel disparity heads); biases zero."""
    kw = dict(width_mult=0.25)
    want = flax_flat(jax.jit(JaxMonodepth(encoder="vgg", **kw).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *_HW, 3))))
    got = port_flat(Monodepth("vgg", generator=torch.Generator().manual_seed(0), **kw))
    assert got.keys() == want.keys()
    for name, w in got.items():
        if name.endswith("bias"):
            assert not w.any() and not want[name].any(), name
            continue
        tol = max(0.05, 4 * np.sqrt(1 / w.size))
        assert abs(w.std() / want[name].std() - 1) < tol, (name, w.std(), want[name].std())


def test_monodepth_checkpoint_resumes_like_an_uninterrupted_run(tmp_path):
    left, right = _stereo_pair(6)
    net = lambda: Monodepth("vgg", generator=torch.Generator().manual_seed(1), **_TINY)  # noqa
    cfg = tmt.MonodepthTrainConfig(learning_rate=_LR)
    a = tmt.MonodepthTrainer(cfg, model=net(), device="cpu")
    a.train_batch(left, right)
    a.save_checkpoint(str(tmp_path))
    b = tmt.MonodepthTrainer(cfg, model=Monodepth("vgg", **_TINY), device="cpu")
    b.restore_checkpoint(str(tmp_path), 1)
    assert b.step == 1
    with torch.no_grad():
        assert torch.equal(a.model(torch.from_numpy(left))[0], b.model(torch.from_numpy(left))[0])
    assert a.train_batch(left, right) == b.train_batch(left, right)
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name


# --- stereo loader and CLI ----------------------------------------------------------


@pytest.fixture(scope="module")
def stereo_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("stereo")
    rng = np.random.default_rng(7)
    lines = []
    for side in ("left", "right"):
        (root / side).mkdir()
    for i in range(5):
        base = rng.integers(0, 255, (72, 150, 3)).astype(np.uint8)
        Image.fromarray(base).save(root / "left" / f"{i}.png")
        Image.fromarray(np.roll(base, -3, axis=1)).save(root / "right" / f"{i}.png")
        lines.append(f"left/{i}.png right/{i}.png\n")
    (root / "files.txt").write_text("".join(lines) + "\n")
    return root


@pytest.mark.parametrize("source", ["dirs", "filenames_file"])
@pytest.mark.parametrize("augment", [True, False])
def test_stereo_batches_bit_equal_to_jax(stereo_tree, source, augment):
    kw = (dict(data_dir=str(stereo_tree)) if source == "dirs" else
          dict(filenames_file=str(stereo_tree / "files.txt"), data_path=str(stereo_tree)))
    jds = jstereo.StereoDataset(image_hw=(32, 64), seed=3, augment=augment, **kw)
    tds = tstereo.StereoDataset(image_hw=(32, 64), seed=3, augment=augment, **kw)
    assert len(tds) == len(jds) == 5
    for prefetch in (2, 0):  # two epochs, the same stream going on
        want = list(jds.batches(2))
        got = list(tds.batches(2, prefetch=prefetch))
        assert len(got) == len(want) == 3
        for (gl, gr), (wl, wr) in zip(got, want):
            assert gl.dtype == np.float32
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gr, wr)
    assert tstereo.read_filenames_file(str(stereo_tree / "files.txt")) == \
        jstereo.read_filenames_file(str(stereo_tree / "files.txt"))
    with pytest.raises(ValueError, match="need data_dir or filenames_file"):
        tstereo.StereoDataset()


def test_monodepth_train_cli_on_the_cpu_writes_weights_jax_reads(stereo_tree, tmp_path):
    out = tmp_path / "out"
    tcli.main(["--data_dir", str(stereo_tree), "--epochs", "1", "--batch_size", "2",
               "--input_height", "128", "--input_width", "256", "--dev_tiny", "--device", "cpu",
               "--model_dir", str(out)])
    assert (out / "checkpoints" / "step_3" / "state.pt").is_file()  # 5 pairs, batch 2
    jnet = JaxMonodepth(encoder="vgg", **_TINY)
    x = jnp.zeros((1, *_HW, 3))
    params = jweights.load_params(
        jax.eval_shape(lambda a: jnet.init(jax.random.PRNGKey(0), a), x),
        str(out / "monodepth.msgpack"))
    assert {k for k in flax_flat(params)} == set(port_flat(Monodepth("vgg", **_TINY)))
    with pytest.raises(SystemExit, match="need data_dir or filenames_file"):
        tcli.main(["--epochs", "1", "--device", "cpu", "--model_dir", str(out)])
