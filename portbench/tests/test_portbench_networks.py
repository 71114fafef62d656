"""Each network's reference is found by the encoder that its configuration
names (``nets.network``): the built-in vgg networks unchanged through the
lookup, any other encoder as a module of its own, and a missing one named
at ``cell.load``."""

import json
import subprocess
import sys
import types

import pytest
import torch

from conftest import BENCH, ROOT, tiny_config
from portbench.harness import cell as cell_lib
from portbench.harness import setup
from portbench.harness import weights as weight_lib
from portbench.reference import frame as ref_frame
from portbench.reference import geometry, nets
from portbench.reference.precision import CONTROL, FLOAT32, full_float32

NAMES = ["munich-bf16", "native-bf16"]


def _direct_weights(c, gen):
    """``setup.make_weights`` as it drew before the lookup: the vgg layer
    lists by name."""
    dtype = torch.bfloat16 if c["compute_dtype"] == "bfloat16" else torch.float32
    net, width = c["networks"], c["networks"].get("width_mult", 1.0)
    nc = net["fcn8s"]["num_classes"]
    fcn = weight_lib.make(nets.fcn_layers(nc, net["fcn8s"]["input_s2d"], width,
                                          net["fcn8s"]["fc_channels"]), gen, dtype)
    mono = weight_lib.make(nets.mono_layers(net["monodepth"]["input_s2d"], width), gen, dtype)
    fcn["upscore8.bias"][0::nc] += c["calibration"]["road_logit_bias"]
    return dict(fcn=fcn, mono=mono)


def _frames(c, n=1, seed=9):
    scale = 1 if c["networks"]["fcn8s"]["input_s2d"] else 2
    shape = (n, c["input_height"] * scale, c["input_width"] * scale, 3)
    return torch.randint(0, 256, shape, dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def _direct_networks(frames, c, mult, weights, prec, disparity=nets.mono_disparity):
    """``frame.networks``'s logits and scaled disparity by direct calls."""
    net = c["networks"]
    with full_float32():
        small = geometry.resize_u8(frames, (c["input_height"], c["input_width"]), prec)
        logits = nets.fcn_logits(weights["fcn"], small, net["fcn8s"]["input_s2d"], prec)
        norm = small / small.new_tensor(255.0)
        s2d = net["monodepth"]["input_s2d"]
        disp = disparity(weights["mono"], norm, s2d, prec)
        if net["monodepth"]["flip_average"]:
            disp = nets.flip_blend(disp, disparity(weights["mono"], norm.flip(2), s2d, prec))
        return logits.float(), disp * ref_frame.disparity_scale(c, mult)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_weights_through_the_lookup_are_the_direct_draw(name):
    c = tiny_config(name)
    got = setup.make_weights(c, torch.Generator().manual_seed(11))
    want = _direct_weights(c, torch.Generator().manual_seed(11))
    _assert_same(got["fcn"], want["fcn"])
    _assert_same(got["mono"], want["mono"])


@pytest.mark.parametrize("prec", [FLOAT32, CONTROL], ids=["float32", "control"])
@pytest.mark.parametrize("name", NAMES)
def test_networks_through_the_lookup_are_the_direct_calls(name, prec):
    c = tiny_config(name)
    weights = setup.make_weights(c, torch.Generator().manual_seed(12))
    frames = _frames(c)
    out = ref_frame.networks(frames, c, 250.0, weights, prec=prec)
    logits, disp = _direct_networks(frames, c, 250.0, weights, prec)
    assert torch.equal(out["logits"], logits)
    assert torch.equal(out["disparity"], disp)


def _toy_module(calls):
    """A one-layer monodepth encoder: a 3x3 convolution to the two
    disparities at the input's resolution."""

    def layers(input_s2d, width):
        assert not input_s2d
        return [nets.Layer("toy", 3, 2, 3)]

    def disparity(weights, images01, input_s2d, prec):
        calls.append(prec)
        x = nets._Net(weights, prec).conv("toy", images01.float().permute(0, 3, 1, 2))
        return 0.3 * torch.sigmoid(x)[:, 0]

    mod = types.ModuleType("portbench.reference.mono_toy")
    mod.layers, mod.disparity = layers, disparity
    return mod


def test_an_encoder_module_is_what_the_configuration_names(monkeypatch):
    calls = []
    toy = _toy_module(calls)
    monkeypatch.setitem(sys.modules, "portbench.reference.mono_toy", toy)
    c = tiny_config("munich-bf16")
    c["networks"]["monodepth"]["encoder"] = "toy"
    assert nets.network("mono", "toy") is toy
    weights = setup.make_weights(c, torch.Generator().manual_seed(13))
    assert set(weights["mono"]) == {"toy.weight", "toy.bias"}
    assert weights["mono"]["toy.weight"].shape == (2, 3, 3, 3)
    frames = _frames(c)
    for prec in (FLOAT32, CONTROL):
        out = ref_frame.networks(frames, c, 250.0, weights, prec=prec)
        _, disp = _direct_networks(frames, c, 250.0, weights, prec, toy.disparity)
        assert torch.equal(out["disparity"], disp)
    assert calls == [FLOAT32] * 4 + [CONTROL] * 4  # the frame and its mirror, twice a side


def _manifest_naming(tmp_path, kind, encoder):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == "munich-bf16")
    c = json.loads((ROOT / conf["file"]).read_text())
    c["networks"]["fcn8s" if kind == "fcn" else "monodepth"]["encoder"] = encoder
    (tmp_path / "munich-bf16.json").write_text(json.dumps(c))
    conf["file"] = str(tmp_path / "munich-bf16.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path / "BENCHMARK.json"


@pytest.mark.parametrize("kind", ["fcn", "mono"])
def test_an_encoder_without_a_module_fails_at_load(tmp_path, kind):
    manifest = _manifest_naming(tmp_path, kind, "nosuch")
    with pytest.raises(SystemExit, match=rf"portbench/reference/{kind}_nosuch\.py"):
        cell_lib.load("munich-bf16.batch8", manifest, BENCH)


def test_the_cells_load_through_the_lookup():
    """Each cell's references are the networks of the encoders its
    configuration names."""
    assert "vgg16" in nets.encoders("fcn") and "vgg" in nets.encoders("mono")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = cell_lib.load(w["name"])
        net = cell.config["networks"]
        fcn, mono = ref_frame.references(cell.config)
        assert fcn.logits is nets.network("fcn", net["fcn8s"]["encoder"]).logits
        assert mono.disparity is nets.network("mono", net["monodepth"]["encoder"]).disparity


def _port_module(kind, encoder, s2d):
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    with torch.device("meta"):
        if kind == "fcn":
            return FCN8s(num_classes=3, fc_channels=nets.FCN_FC, input_s2d=s2d)
        return Monodepth(encoder=encoder, input_s2d=s2d)


def _slots_naming(kind, encoder):
    """The ``networks.<slot>`` of every configuration that names ``encoder``."""
    slot = "fcn8s" if kind == "fcn" else "monodepth"
    files = sorted((BENCH / "configs").glob("*.json"))
    slots = [json.loads(f.read_text())["networks"][slot] for f in files]
    return [s for s in slots if s["encoder"] == encoder]


def assert_params_are_the_ports(ref, slot, kind="mono"):
    """A ``params`` reference's keys and shapes at a configuration's slot
    are those of the port network that the harness builds for it."""
    if "port" in slot:
        with torch.device("meta"):
            port = setup.port_class(slot["port"]["class"])(**slot["port"].get("kwargs", {}))
    else:
        port = _port_module(kind, slot["encoder"], slot["input_s2d"])
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {p.name: p.shape for p in ref.params(slot)} == want


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
@pytest.mark.parametrize("kind,encoder",
                         [(k, e) for k in sorted(nets.FORWARD) for e in nets.encoders(k)])
def test_weight_keys_are_the_ports(kind, encoder, s2d):
    """Every encoder the lookup resolves: the reference's keys and shapes
    are the port's ``state_dict``'s, so ``load_state_dict`` maps them. A
    ``params`` module is held to the port at each configuration that names
    it (its slot gives the layout, whichever ``s2d`` is)."""
    ref = nets.network(kind, encoder)
    if nets.lists_params(ref):
        slots = _slots_naming(kind, encoder)
        assert slots, f"no configuration names the {kind} encoder {encoder}"
        for slot in slots:
            assert_params_are_the_ports(ref, slot, kind)
        return
    extra = (3, nets.FCN_FC) if kind == "fcn" else ()
    shapes = {}
    for layer in ref.layers(s2d, 1.0, *extra):
        shapes[f"{layer.name}.weight"] = tuple(layer.weight_shape)
        shapes[f"{layer.name}.bias"] = (layer.cout,)
    port = {k: tuple(v.shape) for k, v in _port_module(kind, encoder, s2d).state_dict().items()}
    assert shapes == port


def test_the_lookup_loads_neither_jax_nor_the_program():
    """In a fresh process: every encoder resolved, and the modules loaded
    since start hold none of jax, jaxlib, flax or either package."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
before = {{m.split('.')[0] for m in sys.modules}}
from portbench.reference import frame, nets
for kind in nets.FORWARD:
    for enc in nets.encoders(kind):
        nets.network(kind, enc)
new = {{m.split('.')[0] for m in sys.modules}} - before
print(sorted(new & {{'jax', 'jaxlib', 'flax', 'semantic_depth_tpu', 'semantic_depth_tpu_torch'}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
