"""The port's bench-weight trainer (``tools/train_bench_weights_torch.py``)
against the JAX tool (``tools/train_bench_weights.py``, loaded by path) on
the CPU: the first two steps of both networks from the same numpy-seeded
parameters on a tiny phase, the cosine schedule against optax's, ``_graft``,
the cache paths, a run cut by its deadline, and a cached set reused.
Every comparison states its tolerance."""

import importlib.util
import os
import re
import time
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models import weights as tweights
from semantic_depth_tpu_torch.models.from_flax import flax_from_module, load_flax

from torch_helpers import flax_flat, numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

_TOOLS = Path(__file__).resolve().parent.parent / "tools"
_FCN_KW = dict(width_mult=0.125, fc_channels=32)
_MONO_KW = dict(width_mult=0.0625)
_FCN_PHASES = [((64, 128), 4, 2, 2)]
_MONO_PHASES = [((128, 256), 4, 2, 2)]  # the vgg trunk needs 128 rows at least
_LR = 1e-3  # large enough that a step moves float32 parameters well past their rounding


def _load(name):
    spec = importlib.util.spec_from_file_location(name, _TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtool = _load("train_bench_weights")
ttool = _load("train_bench_weights_torch")


def _run(train, phases, **kw):
    """Parameters after each step (a hook every step) and the logged
    losses."""
    states, lines = [], []
    params, truncated = train(phases, lr=_LR, seed=0, log=lines.append,
                              hook=lambda p, _: states.append(flax_flat(
                                  jax.tree.map(np.asarray, p))), hook_every=1, **kw)
    assert not truncated
    losses = [float(m) for m in re.findall(r"loss ([0-9.]+)", " ".join(lines))]
    return states, losses, lines


def _grads(net, loss_fn, params, batches):
    """The port's gradients (flax layout) of ``loss_fn(net, *batch)`` at
    each step's starting parameters."""
    out = []
    for p, batch in zip(params, batches):
        load_flax(net, {"params": _unflat(p)})
        net.zero_grad()
        loss_fn(net, *batch).backward()
        out.append({f"{n.rsplit('.', 1)[0]}.{'kernel' if n.endswith('weight') else 'bias'}":
                    (t.grad.permute(2, 3, 1, 0) if t.dim() == 4 else t.grad).numpy()
                    for n, t in net.named_parameters()})
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        layer, kind = key.rsplit(".", 1)
        tree.setdefault(layer, {})[kind] = v
    return tree


def _batches(pool, n, batch, steps, seed, prepare):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=batch))
        flip = torch.as_tensor(rng.integers(0, 2, size=batch).astype(bool))
        out.append(prepare(pool, idx, flip))
    return out


def _check_steps(got, want, grads, before):
    """The parameters after each step within 2e-6 (tests/test_torch_train.py's
    ``_check_step``) where the gradient is not float32 noise (|g| > 1e-4 of
    the layer's largest; after the second step also for the first step's
    gradient and for Adam's first moment, b1 (1 - b1) g_1 + (1 - b1) g_2),
    and moved there. The losses are compared as the tools log them."""
    for k, (g, w) in enumerate(zip(got, want)):
        for name, ref in w.items():
            big = np.abs(grads[k][name]) > 1e-4 * np.abs(grads[k][name]).max()
            if k:
                m = 0.09 * grads[0][name] + 0.1 * grads[1][name]
                big &= (np.abs(grads[0][name]) > 1e-4 * np.abs(grads[0][name]).max()) & (
                    np.abs(m) > 1e-4 * np.abs(m).max())
            np.testing.assert_allclose(g[name][big], ref[big], rtol=0, atol=2e-6,
                                       err_msg=f"step {k + 1} {name}")
            assert not np.array_equal(ref[big], before[k][name][big]), name


def test_fcn_first_steps_match_the_jax_tool():
    init = numpy_params(JaxFCN8s(num_classes=3, **_FCN_KW), np.zeros((1, 64, 128, 3), np.float32),
                        seed=3)
    flat0 = flax_flat(init)
    kw = dict(init_params=init, **_FCN_KW)
    want, jl, _ = _run(jtool.train_fcn, _FCN_PHASES, **kw)
    got, tl, lines = _run(ttool.train_fcn, _FCN_PHASES, device="cpu", **kw)
    assert len(got) == len(want) == 2 and len(tl) == len(jl) == 2
    assert all(line.startswith("  fcn ph0 (64, 128) step ") for line in lines)

    pools = ttool._pools(_FCN_PHASES, 0)
    imgs, labels = pools[(64, 128)][0][:4], pools[(64, 128)][1][:4]
    gts = torch.from_numpy(ttool._onehot_labels(labels))

    def prepare(pool, idx, flip):
        return (ttool._flip(torch.from_numpy(imgs)[idx].float(), flip),
                ttool._flip(gts[idx], flip))

    net = FCN8s(num_classes=3, **_FCN_KW)
    grads = _grads(net, ttool.fcn_loss, [flat0, got[0]],
                   _batches(None, 4, 2, 2, 0, prepare))
    _check_steps(got, want, grads, [flat0, want[0]])
    assert tl == pytest.approx(jl, abs=1.5e-4)  # printed with 4 decimals


def test_mono_first_steps_match_the_jax_tool():
    init = numpy_params(JaxMonodepth(encoder="vgg", **_MONO_KW),
                        np.zeros((2, 128, 256, 3), np.float32), seed=4)
    flat0 = flax_flat(init)
    kw = dict(init_params=init, **_MONO_KW)
    want, jl, _ = _run(jtool.train_mono, _MONO_PHASES, **kw)
    got, tl, _ = _run(ttool.train_mono, _MONO_PHASES, device="cpu", **kw)
    assert len(got) == len(want) == 2

    pools = ttool._pools(_MONO_PHASES, 1000)
    imgs, labels, disps = (torch.from_numpy(a[:4]) for a in pools[(128, 256)][:3])

    def prepare(pool, idx, flip):
        x = imgs[idx].float()
        wm = 1.0 + torch.tensor(4.0) * (labels[idx] == 7).float()
        return (ttool._flip(x / x.new_tensor(255.0), flip), ttool._flip(disps[idx], flip),
                ttool._flip(wm, flip))

    net = Monodepth(encoder="vgg", **_MONO_KW)
    grads = _grads(net, ttool.mono_loss, [flat0, got[0]], _batches(None, 4, 2, 2, 2, prepare))
    _check_steps(got, want, grads, [flat0, want[0]])
    assert tl == pytest.approx(jl, abs=1.5e-6)  # printed with 6 decimals


def test_cosine_schedule_equals_optax_at_every_step_the_trainer_takes(monkeypatch):
    """The learning rate Adam used at each update of a 10-step run over two
    phases, against optax's ``cosine_decay_schedule(lr, 10)`` at the same
    count (the first update uses lr itself); within rel 1e-6, as numpy's
    and XLA's float32 cos may differ by an ulp."""
    used = []

    class Recording(torch.optim.Adam):
        def step(self, closure=None):
            used.append(self.param_groups[0]["lr"])
            return super().step(closure)

    monkeypatch.setattr(ttool, "_adam", lambda m, lr: Recording(m.parameters(), lr=lr))
    phases = [((64, 128), 2, 1, 4), ((64, 128), 2, 1, 6)]
    ttool.train_fcn(phases, lr=_LR, log=lambda *a: None, device="cpu", **_FCN_KW)
    sched = optax.cosine_decay_schedule(_LR, 10)
    want = [float(sched(np.int32(k))) for k in range(10)]
    assert used[0] == pytest.approx(_LR, rel=1e-7) and len(used) == 10
    assert used == pytest.approx(want, rel=1e-6)
    assert [ttool.cosine_lr(_LR, 10, k) for k in range(12)] == pytest.approx(
        [float(sched(np.int32(k))) for k in range(12)], rel=1e-6)


@pytest.mark.parametrize("net", ["fcn", "mono"])
def test_graft_keeps_the_jax_tools_leaves(net):
    """The input_s2d template with the headline set's leaves where path and
    shape match: leaf for leaf the JAX tool's result."""
    if net == "fcn":
        make = lambda s2d, seed: FCN8s(num_classes=3, input_s2d=s2d,  # noqa: E731
                                       generator=torch.Generator().manual_seed(seed), **_FCN_KW)
    else:
        make = lambda s2d, seed: Monodepth(input_s2d=s2d,  # noqa: E731
                                           generator=torch.Generator().manual_seed(seed),
                                           **_MONO_KW)
    template, src = flax_from_module(make(True, 0)), flax_from_module(make(False, 1))
    got, want = flax_flat(ttool._graft(template, src)), flax_flat(jtool._graft(template, src))
    assert got.keys() == want.keys() == flax_flat(template).keys()
    kept = 0
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(v), err_msg=name)
        kept += np.array_equal(got[name], flax_flat(src).get(name, np.empty(0)))
    assert 0 < kept < len(want)  # some leaves grafted, some left at the template's


def test_bench_weight_paths_equal_the_jax_tools(tmp_path):
    for kw in ({}, dict(full_res=True), dict(native=True), dict(full_res=True, native=True)):
        assert ttool.bench_weight_paths(str(tmp_path), **kw) == jtool.bench_weight_paths(
            str(tmp_path), **kw)


def test_a_run_cut_by_its_deadline_is_parked_and_raises(tmp_path, monkeypatch):
    """A training the budget check lets start (no estimate) and the
    deadline then cuts: parked at ``*.partial``, a whole set, and a raise;
    with the headline set's estimate a budget of one second refuses to
    start at all."""
    kw = dict(width_mult=0.0625, fc_channels=32, fcn_phases=[((64, 128), 4, 2, 100000)],
              mono_phases=[((128, 256), 4, 2, 1)], log=lambda *a: None, device="cpu")
    with pytest.raises(TimeoutError, match="does not fit the remaining"):
        ttool.ensure_bench_weights(str(tmp_path), deadline=time.time() + 1.0, **kw)
    assert os.listdir(tmp_path) == []
    monkeypatch.setitem(ttool._EST_TRAIN_S, "", (0, 0))
    with pytest.raises(TimeoutError, match="parked at .*fcn8s.msgpack.partial"):
        ttool.ensure_bench_weights(str(tmp_path), deadline=time.time() + 1.0, **kw)
    assert sorted(os.listdir(tmp_path)) == ["fcn8s.msgpack.partial"]
    parked = tweights.load_params(str(tmp_path / "fcn8s.msgpack.partial"))
    load_flax(FCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), parked)  # a whole set
    with pytest.raises(TimeoutError, match="does not fit"):  # past the deadline: no start
        ttool.ensure_bench_weights(str(tmp_path), deadline=time.time() - 1, device="cpu")


@pytest.mark.parametrize("kw, suffix", [(dict(full_res=True), "_fullres"),
                                        (dict(native=True), "_native")])
def test_the_full_res_and_native_estimates_refuse_a_budget_they_do_not_fit(tmp_path, kw,
                                                                        suffix):
    """The measured full-res and native estimates: a budget a second short
    of the set's FCN-8s estimate refuses to start it (its warm start cached),
    and one a minute past it starts it."""
    est_fcn, est_mono = ttool._EST_TRAIN_S[suffix]
    assert est_fcn > 0 and est_mono > 0
    base = ttool.bench_weight_paths(str(tmp_path), full_res=suffix == "_native")
    if suffix == "_native":
        base += ttool.bench_weight_paths(str(tmp_path))
    for p in base:  # the warm starts, cached
        tweights.save_params({"params": {"x": {"bias": np.zeros(1, np.float32)}}}, p)
    with pytest.raises(TimeoutError, match=f"FCN-8s{suffix} training .*does not fit"):
        ttool.ensure_bench_weights(str(tmp_path), deadline=time.time() + est_fcn - 1,
                                   device="cpu", **kw)
    started = []

    def fake_train(*a, **k):
        started.append(k["input_s2d"])
        raise RuntimeError("started")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttool, "train_fcn", fake_train)
        with pytest.raises(RuntimeError, match="started"):
            ttool.ensure_bench_weights(str(tmp_path), deadline=time.time() + est_fcn + 60,
                                       device="cpu", **kw)
    assert started == [suffix == "_native"]


def test_a_cached_set_is_reused_without_training(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a cached set must not train")

    monkeypatch.setattr(ttool, "train_fcn", boom)
    monkeypatch.setattr(ttool, "train_mono", boom)
    paths = ttool.bench_weight_paths(str(tmp_path))
    for p in paths:
        tweights.save_params({"params": {"x": {"bias": np.zeros(1, np.float32)}}}, p)
    assert ttool.ensure_bench_weights(str(tmp_path), device="cpu") == paths
