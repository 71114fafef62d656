"""Networks with any kind of parameter, by the names their configuration
gives: the existing configurations' weights and port networks are drawn
and built bit for bit as before the ``params`` and ``port`` hooks, and a
toy transformer (``toy_vit``: Linear layers, LayerNorm, a class token, a
position table, bias-less convolutions) enters through them alone."""

import json
import shutil
import sys
import types

import pytest
import torch
import torch.nn.functional as F

import toy_vit
from conftest import tiny_config
from portbench import run as bench_run
from portbench.harness import cell as cell_lib
from portbench.harness import setup
from portbench.harness import weights as weight_lib
from portbench.reference import mono_resnet50, nets
from portbench.reference.precision import CONTROL, FLOAT32, to_float8
from test_portbench_networks import assert_params_are_the_ports

NAMES = ["munich-bf16", "native-bf16", "munich-resnet50-bf16"]
SEED = 2 ** 31 + 3

# --- the draws and builds before the hooks, copied --------------------------

_TRUNC_STD = 0.87962566103423978
_CLAMPED_STD = 0.9594461556733253  # a unit normal clamped at +-2


def _make_before(layers, gen, dtype):
    """``weights.make`` before the hooks."""
    dev = gen.device
    sizes = [int(torch.Size(layer.weight_shape).numel()) for layer in layers]
    draw = torch.randn(sum(sizes), generator=gen, device=dev).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for layer, n in zip(layers, sizes):
        if layer.init == "decoder":
            std = 0.01
        else:
            std = (1.0 / (layer.cin * layer.k * layer.k)) ** 0.5 / _TRUNC_STD
        out[f"{layer.name}.weight"] = (draw[at:at + n] * std).to(dtype).view(layer.weight_shape)
        out[f"{layer.name}.bias"] = torch.zeros(layer.cout, dtype=dtype, device=dev)
        at += n
    return out


def _weights_before(c, gen):
    """``setup.make_weights`` before the hooks, each encoder's layer list by name."""
    dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
    net = c["networks"]
    width = net.get("width_mult", 1.0)
    f, m = net["fcn8s"], net["monodepth"]
    mono_layers = {"vgg": nets.mono_layers, "resnet50": mono_resnet50.layers}[m["encoder"]]
    fcn = _make_before(nets.fcn_layers(f["num_classes"], f["input_s2d"], width, f["fc_channels"]),
                       gen, dtype)
    mono = _make_before(mono_layers(m["input_s2d"], width), gen, dtype)
    nc = f["num_classes"]
    fcn["upscore8.bias"][0::nc] += c["calibration"]["road_logit_bias"]
    return dict(fcn=fcn, mono=mono)


def _networks_before(c, weights):
    """``setup._port_networks`` before the hooks."""
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
    net = c["networks"]
    with torch.device("meta"):
        fcn = FCN8s(num_classes=net["fcn8s"]["num_classes"], compute_dtype=dtype,
                    fc_channels=net["fcn8s"]["fc_channels"], input_s2d=net["fcn8s"]["input_s2d"],
                    width_mult=net.get("width_mult", 1.0))
        mono = Monodepth(encoder=net["monodepth"]["encoder"], compute_dtype=dtype,
                         input_s2d=net["monodepth"]["input_s2d"],
                         width_mult=net.get("width_mult", 1.0))
    for module, w in ((fcn, weights["fcn"]), (mono, weights["mono"])):
        module.load_state_dict({k: v.clone() for k, v in w.items()}, assign=True)
    return fcn, mono


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module", params=NAMES)
def drawn(request):
    """(config, weights now, weights before) at the tests' width, seed 17."""
    c = tiny_config(request.param)
    return (c, setup.make_weights(c, torch.Generator().manual_seed(17)),
            _weights_before(c, torch.Generator().manual_seed(17)))


def test_weights_are_drawn_as_before(drawn):
    _, now, before = drawn
    assert list(now) == ["fcn", "mono"]
    _assert_same(now["fcn"], before["fcn"])
    _assert_same(now["mono"], before["mono"])


def test_port_networks_are_built_as_before(drawn):
    c, now, _ = drawn
    for got, want in zip(setup._port_networks(c, now, torch.device("cpu")),
                         _networks_before(c, now)):
        assert type(got) is type(want)
        _assert_same(got.state_dict(), want.state_dict())


def test_native_input_s2d_networks_are_drawn_as_before():
    c = tiny_config("native-bf16")
    now = setup.make_weights(c, torch.Generator().manual_seed(18))
    before = _weights_before(c, torch.Generator().manual_seed(18))
    nc = c["networks"]["fcn8s"]["num_classes"]
    assert now["fcn"]["conv1_1.weight"].shape[1] == 12 == now["mono"]["enc1a.weight"].shape[1]
    assert now["fcn"]["upscore8.weight"].shape[1] == 4 * nc
    for key in ("upconv0.weight", "iconv0.weight", "disp0.weight", "disp0.bias"):
        assert torch.equal(now["mono"][key], before["mono"][key]), key
    fcn, mono = setup._port_networks(c, now, torch.device("cpu"))
    assert fcn.input_s2d and mono.input_s2d


def test_upscore8_calibration_on_every_phase(drawn):
    c, now, before = drawn
    nc = c["networks"]["fcn8s"]["num_classes"]
    bias = now["fcn"]["upscore8.bias"]
    phases = bias.numel() // nc
    assert phases == (4 if c["networks"]["fcn8s"]["input_s2d"] else 1)
    assert torch.equal(bias, before["fcn"]["upscore8.bias"])
    road = bias.view(phases, nc)
    assert (road[:, 0] == c["calibration"]["road_logit_bias"]).all()
    assert (road[:, 1:] == 0).all()


# --- the laws of a Param ----------------------------------------------------


def test_param_laws_and_their_draw_order():
    n = 100_000
    specs = [nets.Param("a", (1000,), "ones"), nets.Param("b", (n,), "lecun", fan_in=50),
             nets.Param("c", (10, 3), "zeros"),
             nets.Param("d", (n // 100, 100), "normal", std=0.02)]
    got = weight_lib.make_params(specs, torch.Generator().manual_seed(3), torch.float32)
    assert list(got) == ["a", "b", "c", "d"]
    assert torch.equal(got["a"], torch.ones(1000)) and torch.equal(got["c"], torch.zeros(10, 3))
    assert float(got["b"].std()) == pytest.approx((1.0 / 50) ** 0.5, rel=0.05)
    assert float(got["d"].std()) == pytest.approx(0.02, rel=0.05)
    # one draw over the drawn laws in list order; ones and zeros take none
    draw = torch.randn(2 * n, generator=torch.Generator().manual_seed(3)).clamp_(-2.0, 2.0)
    assert torch.equal(got["b"], draw[:n] * ((1.0 / 50) ** 0.5 / _CLAMPED_STD))
    assert torch.equal(got["d"].reshape(-1), draw[n:] * (0.02 / _CLAMPED_STD))
    # without "b", "d" takes the draw's first slice; in the type asked for
    rest = weight_lib.make_params([specs[0], specs[2], specs[3]],
                                  torch.Generator().manual_seed(3), torch.bfloat16)
    assert rest["d"].dtype == torch.bfloat16
    assert torch.equal(rest["d"].reshape(-1), (draw[:n] * (0.02 / _CLAMPED_STD)).bfloat16())


@pytest.mark.parametrize("bad", [dict(law="xavier"), dict(law="lecun"), dict(law="normal"),
                                 dict(law="normal", std=-1.0)], ids=str)
def test_a_param_states_its_law(bad):
    with pytest.raises(ValueError, match="w"):
        nets.Param("w", (2, 2), **bad)


def test_a_param_listed_twice_is_refused():
    twice = [nets.Param("w", (2,), "zeros"), nets.Param("w", (2,), "ones")]
    with pytest.raises(ValueError, match="w is listed twice"):
        weight_lib.make_params(twice, torch.Generator(), torch.float32)


# --- the reference's products under the control -----------------------------


def test_products_take_float8_operands_under_the_control():
    g = torch.Generator().manual_seed(5)
    x, a = torch.randn(4, 9, 64, generator=g), torch.randn(4, 9, 64, generator=g)
    b = torch.randn(4, 64, 16, generator=g)
    w = {"l.weight": torch.randn(32, 64, generator=g), "l.bias": torch.randn(32, generator=g)}
    f32, ctl = nets._Net(w, FLOAT32), nets._Net(w, CONTROL)
    cases = [(f32.linear("l", x), ctl.linear("l", x),
              F.linear(to_float8(x), to_float8(w["l.weight"]), w["l.bias"])),
             (f32.matmul(a, b), ctl.matmul(a, b), to_float8(a) @ to_float8(b))]
    for ref, control, float8 in cases:
        assert torch.equal(control, float8)
        # farther than bfloat16's rounding: the operands were float8's
        assert float((control - ref).norm() / ref.norm()) > 2 ** -8
    assert torch.equal(cases[0][0], F.linear(x, w["l.weight"], w["l.bias"]))


def test_conv_takes_no_bias_and_groups():
    g = torch.Generator().manual_seed(6)
    x, w = torch.randn(2, 4, 8, 8, generator=g), torch.randn(6, 2, 3, 3, generator=g)
    got = nets._Net({"c.weight": w}, FLOAT32).conv("c", x, groups=2)
    assert torch.equal(got, F.conv2d(x, w, None, 1, 1, 1, 2))


# --- the toy through the lookup, the draw, the port and a cell --------------


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, toy_vit.REF, toy_vit.reference())
    monkeypatch.setitem(sys.modules, toy_vit.PORT, toy_vit.port())


def _toy_config():
    c = tiny_config("munich-bf16")
    c["networks"]["monodepth"] = toy_vit.slot()
    return c


def test_toy_draws_its_params_and_loads_strictly(toy):
    c = _toy_config()
    ref = nets.network("mono", "toyvit")
    assert nets.lists_params(ref)
    assert_params_are_the_ports(ref, c["networks"]["monodepth"])
    weights = setup.make_weights(c, torch.Generator().manual_seed(19))
    assert "patch.bias" not in weights["mono"] and "head.bias" not in weights["mono"]
    assert torch.equal(weights["mono"]["norm1.weight"], torch.ones(32, dtype=torch.bfloat16))
    _, mono = setup._port_networks(c, weights, torch.device("cpu"))
    assert type(mono).__name__ == "ToyViT"
    state = mono.state_dict()
    assert set(state) == set(weights["mono"])
    for k, v in weights["mono"].items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k
    assert (mono.state_dict()["cls_token"].data_ptr()
            != weights["mono"]["cls_token"].data_ptr())  # the port holds copies


@pytest.mark.parametrize("side", ["reference", "port"])
def test_a_key_missing_from_either_side_raises_naming_it(toy, side):
    c = _toy_config()
    weights = setup.make_weights(c, torch.Generator().manual_seed(20))
    if side == "reference":
        key = "attn.proj.bias"
        del weights["mono"][key]
    else:
        key = "attn.gate.weight"
        weights["mono"][key] = torch.zeros(2)
    with pytest.raises(RuntimeError, match=key.replace(".", r"\.")):
        setup._port_networks(c, weights, torch.device("cpu"))


@pytest.mark.parametrize("path", ["semantic_depth_tpu.models.fcn8s:FCN8s", "torch.nn:Linear",
                                  "semantic_depth_tpu_torchx:Net",
                                  "semantic_depth_tpu_torch.models.fcn8s"])
def test_a_port_class_lies_inside_the_port(path):
    jax_package = "semantic_depth_tpu" in sys.modules
    with pytest.raises(ValueError, match="inside semantic_depth_tpu_torch"):
        setup.port_class(path)
    assert ("semantic_depth_tpu" in sys.modules) == jax_package  # refused before any import


@pytest.mark.parametrize("exports,missing", [
    ((), "layers or params, disparity"), (("disparity",), "layers or params"),
    (("params",), "disparity"), (("layers", "logits"), "disparity")], ids=str)
def test_network_needs_its_parameters_and_forward_pass(monkeypatch, exports, missing):
    mod = types.ModuleType("portbench.reference.mono_bare")
    for name in exports:
        setattr(mod, name, lambda *a: None)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    with pytest.raises(LookupError, match=f"mono_bare.py does not define {missing}$"):
        nets.network("mono", "bare")


def _toy_cell(tiny, tmp_path):
    """The tiny munich batch8 cell with the toy as its monodepth, under
    that cell's limits."""
    manifest, data = tiny
    spec = json.loads(manifest.read_text())
    c = _toy_config()
    (tmp_path / "toy.json").write_text(json.dumps(c))
    spec["configs"].append(dict(name="toy", source="tests", file=str(tmp_path / "toy.json"),
                                reduced=[], why="tests"))
    spec["workloads"].append(dict(name="toy.batch8", config="toy", traffic="batch8", chips=1,
                                  why="tests"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(data / "traffic", tmp_path / "traffic")
    (tmp_path / "limits").mkdir()
    shutil.copy(data / "limits" / "munich-bf16.batch8.json",
                tmp_path / "limits" / "toy.batch8.json")
    return cell_lib.load("toy.batch8", tmp_path / "BENCHMARK.json", tmp_path)


def _dropped_block(bench):
    """The toy's attention block dropped from the program's network: its
    two residual branches made nought, so the block passes its input on."""
    mono = bench.pipe.mono
    with torch.no_grad():
        for lin in (mono.attn.proj, mono.mlp.fc2):
            lin.weight.zero_()
            lin.bias.zero_()


def test_toy_runs_correct_through_a_cell_and_fails_without_its_block(tiny, tmp_path, toy):
    cell = _toy_cell(tiny, tmp_path)
    log = lambda msg: print(msg, file=sys.stderr)  # noqa: E731
    out, rows = bench_run.measure(cell, SEED, 0.5, False, "cpu", log=log)
    assert out["correct"], rows
    assert "disp_gap" in out["check"]
    out, rows = bench_run.measure(cell, SEED, 0.5, False, "cpu", log=log, broken=_dropped_block)
    assert not out["correct"], rows
    assert out["check"]["disp_gap"]["value"] > out["check"]["disp_gap"]["limit"]
