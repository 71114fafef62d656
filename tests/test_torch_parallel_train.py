"""Multi-device training of the port (``parallel/train_step.py``,
``FCNTrainer(mesh=...)``, ``MonodepthTrainer(mesh=...)``) on the CPU: gloo
ranks started by ``launch.run_ranks`` (one group of 4 ranks, one of 2), at
the JAX sharded tests' shapes (tests/test_parallel.py: FCN-8s width 0.25
with fc 128 on 32x64, batch 8; monodepth-vgg width 0.0625 on 128x256,
batch 8).

The sharded steps are held against the JAX single-device trainers from the
same numpy-seeded parameters at keep 1.0 (tests/test_torch_train.py's
tolerances; JAX's gradients read back from optax's first moment), and at
keep 0.5 against the port's single-device step with the same seed (the
dropout masks are the single-device ones). The JAX sharded step is held
against JAX single by tests/test_parallel.py and does not run here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu.train import monodepth_trainer as jmt
from semantic_depth_tpu.train import trainer as jtrainer
from semantic_depth_tpu_torch.models import Monodepth
from semantic_depth_tpu_torch.models.from_flax import load_flax
from semantic_depth_tpu_torch.parallel import make_sharded_train_step, shard_fcn_params
from semantic_depth_tpu_torch.train import monodepth_trainer as tmt
from semantic_depth_tpu_torch.parallel.launch import run_ranks

import test_torch_parallel_ranks as cases
from torch_helpers import flax_flat, numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

_TIMEOUT = 240  # seconds for one group of ranks, its collectives included
_FCN_KW = dict(width_mult=0.25, fc_channels=128)
_MONO_KW = dict(width_mult=0.0625)
_HW, _MONO_HW = (32, 64), (128, 256)
_LR = 1e-3  # large enough that a step moves float32 parameters well past their rounding


def _fcn_batch():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (8, *_HW, 3)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, *_HW))]
    return images, labels


def _stereo_batch():
    """Smoothed random bases and their 4-px shifts."""
    rng = np.random.default_rng(2)
    base = rng.uniform(0, 1, (8, *_MONO_HW, 3)).astype(np.float32)
    for _ in range(2):
        base[:, :, 1:-1] = (base[:, :, :-2] + base[:, :, 1:-1] + base[:, :, 2:]) / 3
        base[:, 1:-1] = (base[:, :-2] + base[:, 1:-1] + base[:, 2:]) / 3
    return base, np.roll(base, -4, axis=2)


def _second_step_mask(opt_states):
    """Where the second step is decided: ``_big`` of the first step's
    gradients and of the first moment after the second step."""
    g1, mu2 = _big(_jax_grads(opt_states, 0)), _big(flax_flat(opt_states[1][0].mu))
    return {n: g1[n] & mu2[n] for n in g1}


def _jax_grads(opt_states, k):
    """JAX's step-k gradients from optax's first moments: mu_1 = (1 - b1) g_1,
    mu_2 = b1 mu_1 + (1 - b1) g_2."""
    mu = [flax_flat(s[0].mu) for s in opt_states]
    if k == 0:
        return {n: v / np.float32(0.1) for n, v in mu[0].items()}
    return {n: (mu[1][n] - np.float32(0.9) * mu[0][n]) / np.float32(0.1) for n in mu[0]}


def _big(grads):
    """Where |g| > 1e-4 of the layer's largest."""
    return {n: np.abs(g) > 1e-4 * np.abs(g).max() for n, g in grads.items()}


def _check(got, want_loss, grads_want, before, after, cm_want=None, earlier=None):
    """tests/test_torch_train.py's ``_check_step`` on gathered tensors: loss
    rel 1e-5, cm within 0.1% of the pixels, the gradients rtol 1e-4 / atol
    1e-4 of the layer's largest, the post-step parameters within 2e-6 where
    |g| > 1e-4 max|g| (elsewhere Adam's step on float32 noise may go either
    way). A second step from the first step's parameters carries the first
    step's update, and Adam's second update is lr * m / (sqrt(v) + eps)
    with m = b1 (1 - b1) g_1 + (1 - b1) g_2, noise where g_1 and g_2 cancel:
    it is checked only where ``earlier`` (``_big`` of g_1 and of JAX's m)
    holds too."""
    assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
    if cm_want is not None:
        assert np.abs(got["cm"] - cm_want).sum() / 2 <= max(1, 1e-3 * cm_want.sum())
    for name, g_want in grads_want.items():
        scale = np.abs(g_want).max()
        np.testing.assert_allclose(got["grads"][name], g_want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
        big = np.abs(g_want) > 1e-4 * scale
        if earlier is not None:
            big &= earlier[name]
        np.testing.assert_allclose(got["params"][name][big], after[name][big], rtol=0,
                                   atol=2e-6, err_msg=name)
        assert not np.array_equal(after[name][big], before[name][big]), name


@pytest.fixture(scope="module")
def fcn_case(tmp_path_factory):
    """The JAX single-device trainer's two steps at keep 1.0, the port's
    single-process run (two steps, a checkpoint after the first), and the
    sharded runs: (dp 2, tp 2) on 4 ranks, (1, 2) and (2, 1) on 2 ranks
    (with the monodepth case in the same group of 2)."""
    images, labels = _fcn_batch()
    params = numpy_params(JaxFCN8s(num_classes=3, **_FCN_KW), images[:1], seed=2)
    cfg = jconfig.TrainConfig(learning_rate=_LR, image_shape=_HW, batch_size=8)
    jt = jtrainer.FCNTrainer(cfg, model=JaxFCN8s(num_classes=3, dropout_keep_prob=1.0, **_FCN_KW),
                             init_params=params)
    states, metrics, opt_states = [jax.tree.map(np.asarray, params)], [], []
    for _ in range(2):
        metrics.append(jt.train_batch(jnp.asarray(images), jnp.asarray(labels)))
        states.append(jax.tree.map(np.asarray, jt.state.params))
        opt_states.append(jax.tree.map(np.asarray, jt.state.opt_state))

    tmp = tmp_path_factory.mktemp("parallel_train")
    spec = dict(lr=_LR, hw=_HW, fcn_kw=_FCN_KW, params=states[0], images=images, labels=labels,
                dir=str(tmp), single_ckpt=str(tmp / "single"))
    single = cases.fcn_trainer(spec)
    single_steps = [cases.full_step(single, None, images, labels)]
    single.save_checkpoint(spec["single_ckpt"])
    single_steps.append(cases.full_step(single, None, images, labels))

    left, right = _stereo_batch()
    mono_params = numpy_params(JaxMonodepth(encoder="vgg", **_MONO_KW), left[:1], seed=5)
    jm = jmt.MonodepthTrainer(jmt.MonodepthTrainConfig(learning_rate=_LR),
                              model=JaxMonodepth(encoder="vgg", **_MONO_KW),
                              init_params=mono_params)
    mono = dict(states=[jax.tree.map(np.asarray, mono_params)], metrics=[], opt_states=[])
    for _ in range(2):
        mono["metrics"].append(jm.train_batch(jnp.asarray(left), jnp.asarray(right)))
        mono["states"].append(jax.tree.map(np.asarray, jm.params))
        mono["opt_states"].append(jax.tree.map(np.asarray, jm.opt_state))
    mspec = dict(lr=_LR, mono_kw=_MONO_KW, mono_params=mono["states"][0], left=left,
                 right=right)

    ranks = {4: run_ranks(cases.fcn_mesh_cases, 4, dict(spec, meshes=[(2, 2)]), device="cpu",
                          timeout_s=_TIMEOUT)}
    two = run_ranks(cases.run_steps, 2, [("fcn_mesh_cases", (dict(spec, meshes=[(1, 2), (2, 1)]),)),
                                         ("mono_mesh_case", (mspec,))],
                    device="cpu", timeout_s=_TIMEOUT)
    ranks[2] = [r[0] for r in two]
    mono["ranks"] = [r[1] for r in two]
    return dict(states=states, metrics=metrics, opt_states=opt_states, ranks=ranks,
                single=single_steps, spec=spec, mono=mono)


_MESHES = [(4, (2, 2)), (2, (1, 2)), (2, (2, 1))]


def _ranks(fcn_case, world, mesh):
    return [r[mesh] for r in fcn_case["ranks"][world]]


@pytest.mark.parametrize("world,mesh", _MESHES)
def test_sharded_fcn_steps_match_the_jax_single_device_trainer(fcn_case, world, mesh):
    got = _ranks(fcn_case, world, mesh)[0]["steps"]
    flat_states = [flax_flat(s) for s in fcn_case["states"]]
    grads = [_jax_grads(fcn_case["opt_states"], k) for k in range(2)]
    for k in range(2):
        _check(got[k], fcn_case["metrics"][k]["loss"], grads[k], flat_states[k],
               flat_states[k + 1], fcn_case["metrics"][k]["cm"],
               _second_step_mask(fcn_case["opt_states"]) if k else None)


@pytest.mark.parametrize("world,mesh", _MESHES)
def test_sharded_fcn_step_at_keep_half_matches_the_port_single_step(fcn_case, world, mesh):
    """Dropout 0.5 with the same seed: each rank cuts the single-device
    masks to its block, so both steps' losses agree with the single-device
    port's within rel 1e-6 (JAX's sharded test allows 1e-4); dropout moves
    the second loss by more than 50 times that from keep 1.0's."""
    single = fcn_case["ranks"][world][0]["single_keep05"]
    for res in _ranks(fcn_case, world, mesh):
        for got, want in zip(res["keep05"], single):
            assert got == pytest.approx(want, rel=1e-6)
    assert abs(single[1] - fcn_case["single"][1]["loss"]) > 5e-5 * single[1]


@pytest.mark.parametrize("world,mesh", _MESHES)
def test_replicas_bit_equal_on_every_rank_after_two_steps(fcn_case, world, mesh):
    """Every replicated parameter and its Adam moments, and each tp block
    with its moments on the ranks that hold the same block."""
    ranks = _ranks(fcn_case, world, mesh)
    assert len({r["digests"]["replicated"] for r in ranks}) == 1
    for tp_rank in range(mesh[1]):
        blocks = {r["digests"]["blocks"] for r in ranks if r["tp_rank"] == tp_rank}
        assert len(blocks) == 1
    if mesh[1] > 1:  # the tp ranks hold different blocks
        assert len({r["digests"]["blocks"] for r in ranks}) == mesh[1]
    mono = fcn_case["mono"]["ranks"]
    assert len({r["digest"] for r in mono}) == 1


@pytest.mark.parametrize("world,mesh", _MESHES)
def test_sharded_fcn_errors_and_fit_drop_the_ragged_batch(fcn_case, world, mesh):
    """JAX's ValueError for a batch that does not split over dp, and fit's
    one line when it drops the ragged final batch (construction with batch
    1 raised nothing)."""
    for res in _ranks(fcn_case, world, mesh):
        if mesh[0] == 1:
            assert res["ragged"] is None and "dropping" not in res["fit_printed"]
            assert res["fit_step"] == 4  # 2 steps, set_params, then fit's two batches
            continue
        assert res["ragged"] == (
            f"batch of 3 cannot be split over dp={mesh[0]}; feed batches divisible by dp "
            "(fit() drops the ragged final batch in mesh mode)")
        assert res["fit_printed"].count(
            "mesh mode: dropping the ragged final batch each epoch (dataset size not a "
            "multiple of batch_size=8)") == 1
        assert res["fit_step"] == 2  # one step past set_params: the ragged batch was dropped
        assert np.isfinite(res["fit_loss"])


@pytest.mark.parametrize("world,mesh", _MESHES)
def test_set_params_reshards_and_checkpoints_resume_across_layouts(fcn_case, world, mesh):
    """``set_params`` re-shards: its step equals the first step bit for bit.
    A sharded checkpoint resumes on one process like the uninterrupted
    sharded run, and a single-process one resumes sharded like the
    uninterrupted single run (loss rel 1e-5; the parameters within 2e-6
    where |g| > 1e-4 max|g|, within 2 lr elsewhere)."""
    assert all(r["tree_round_trip"] for r in _ranks(fcn_case, world, mesh))
    res = _ranks(fcn_case, world, mesh)[0]
    for name, v in res["steps"][0]["params"].items():
        np.testing.assert_array_equal(res["again"]["params"][name], v, err_msg=name)

    spec = fcn_case["spec"]
    t = cases.fcn_trainer(spec)
    t.restore_checkpoint(os.path.join(spec["dir"], f"{mesh[0]}x{mesh[1]}"), 1)
    assert t.step == 1
    resumed = cases.full_step(t, None, spec["images"], spec["labels"])
    for got, want in ((resumed, res["steps"][1]), (res["resumed"], fcn_case["single"][1])):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for name, big in _big(want["grads"]).items():
            np.testing.assert_allclose(got["params"][name][big], want["params"][name][big],
                                       rtol=0, atol=2e-6, err_msg=name)
            np.testing.assert_allclose(got["params"][name], want["params"][name], rtol=0,
                                       atol=2 * _LR, err_msg=name)


def _agreement(got, grads_want, before_step, after, lr):
    """``probes.train_step_agreement``'s numbers (the card-against-CPU rule
    of chip_smoke.py): the gradients' error over all parameters and the
    worst parameter's, each relative to the norm, and the largest
    post-step difference over lr where |g| > 1e-4 of the model's largest."""
    g_max = max(np.abs(g).max() for g in grads_want.values())
    err2 = norm2 = worst = step = 0.0
    for name, g in grads_want.items():
        d2 = float(((got["grads"][name].astype(np.float64) - g) ** 2).sum())
        n2 = float((g.astype(np.float64) ** 2).sum())
        err2, norm2, worst = err2 + d2, norm2 + n2, max(worst, (d2 / n2) ** 0.5)
        big = np.abs(g) > 1e-4 * g_max
        step = max(step, float(np.abs(got["params"][name][big] - after[name][big]).max()) / lr)
    return (err2 / norm2) ** 0.5, worst, step


def test_sharded_monodepth_steps_match_the_jax_single_device_trainer(fcn_case):
    """dp=2 over the two ranks. The losses within rel 1e-4 of JAX's: at
    batch 8 JAX's float32 means over 786k elements are themselves 1.35e-5
    from the float64 loss, which the sharded port's first loss matches
    within rel 1e-6. The gradients by ``_agreement``'s rule (within 1e-3 of
    their norm, 1e-2 in each parameter) in both steps, and the first step's
    parameters within 1e-2 lr where the gradient is not noise. At batch 8
    single elements of the gradients differ by more than ``_check``
    allows, the single-device port's as much as the sharded one's (both
    against JAX and against a float64 run of the port's loss): the warp's
    bilinear gradient jumps where a sample crosses a pixel, and float32 and
    float64 put a few samples on either side. So the gradients are
    compared as a whole, not element by element."""
    m = fcn_case["mono"]
    got = m["ranks"][0]["steps"]
    flat_states = [flax_flat(s) for s in m["states"]]
    for k in range(2):
        want = m["metrics"][k]
        assert got[k]["metrics"].keys() == want.keys()
        for key in want:
            assert got[k]["metrics"][key] == pytest.approx(want[key], rel=1e-4), key
        grad_rel, worst, step = _agreement(got[k], _jax_grads(m["opt_states"], k),
                                           flat_states[k], flat_states[k + 1], _LR)
        assert grad_rel < 1e-3 and worst < 1e-2, (k, grad_rel, worst)
        if k == 0:
            assert step < 1e-2, step
    net = load_flax(Monodepth(encoder="vgg", **_MONO_KW), m["states"][0]).double()
    net.compute_dtype = torch.float64
    left, right = (torch.from_numpy(x).double() for x in _stereo_batch())
    with torch.no_grad():
        loss64, _ = tmt.monodepth_loss(net(left), left, right, tmt.MonodepthTrainConfig())
    assert got[0]["metrics"]["loss"] == pytest.approx(float(loss64), rel=1e-6)
    for res in m["ranks"]:
        assert res["ragged"] == "batch size 3 must be a multiple of the mesh's device count 2"


def test_the_package_exports_the_sharded_step():
    from semantic_depth_tpu_torch import parallel

    assert {"make_sharded_train_step", "shard_fcn_params"} <= set(parallel.__all__)
    assert callable(make_sharded_train_step) and callable(shard_fcn_params)
