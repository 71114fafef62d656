"""Set-up draws a seed's frames and weights again where the reference finds
no road to measure on them (``setup._draw``, ``frame.NoRoad``), from the
same generator, and fails as before where the program alone finds none."""

import math

import pytest
import torch

from portbench.harness import cell as cell_lib
from portbench.harness import setup
from portbench.reference import frame as ref_frame

SEED = 2 ** 31 + 9


def _cell(tiny):
    manifest, data = tiny
    return cell_lib.load("munich-bf16.batch8", manifest, data)


def _failing_first(monkeypatch, how, times=1):
    """The first ``times`` calibrations leave no road: the reference's own
    batch (``calibration``), or a slab where no point lies (``warm-up``)."""
    real = ref_frame.calibrated_depth
    calls = []

    def calibrated_depth(*a, **k):
        calls.append(1)
        if len(calls) > times:
            return real(*a, **k)
        if how == "calibration":
            raise ref_frame.NoRoad("the calibration batch leaves no denoised road point")
        return 1.0e4

    monkeypatch.setattr(ref_frame, "calibrated_depth", calibrated_depth)
    return calls


@pytest.mark.parametrize("how", ["calibration", "warm-up"])
def test_a_draw_with_no_road_is_drawn_again_from_the_seed(tiny, monkeypatch, how):
    cell = _cell(tiny)
    first = setup.build(cell, SEED, "cpu")
    calls = _failing_first(monkeypatch, how)
    again = setup.build(cell, SEED, "cpu")
    assert len(calls) == 2 and again.setup_parts["redraws"] == 1.0
    assert "redraws" not in first.setup_parts
    assert not torch.equal(again.frames_dev, first.frames_dev)
    calls.clear()
    same = setup.build(cell, SEED, "cpu")  # the same seed draws the same twice
    assert torch.equal(same.frames_dev, again.frames_dev)
    for k, v in again.weights["mono"].items():
        assert torch.equal(same.weights["mono"][k], v), k
    assert same.depth == again.depth and math.isfinite(same.depth)


def test_set_up_gives_up_after_its_draws(tiny, monkeypatch):
    calls = _failing_first(monkeypatch, "calibration", times=setup.DRAWS)
    with pytest.raises(ref_frame.NoRoad, match="no denoised road point"):
        setup.build(_cell(tiny), SEED, "cpu")
    assert len(calls) == setup.DRAWS


def test_a_width_only_the_program_misses_fails_set_up(tiny, monkeypatch):
    """The program's widths made nan: the reference's tail measures one on
    the same masks and disparity, so the program is at fault."""
    from semantic_depth_tpu_torch.pipeline import SemanticDepthPipeline

    real = SemanticDepthPipeline.process_batch

    def no_width(self, *a, **k):
        out = real(self, *a, **k)
        return out.replace(dist_rw=torch.full_like(out.dist_rw, math.nan))

    monkeypatch.setattr(SemanticDepthPipeline, "process_batch", no_width)
    with pytest.raises(RuntimeError, match="reference's tail keeps") as err:
        setup.build(_cell(tiny), SEED, "cpu")
    assert not isinstance(err.value, ref_frame.NoRoad)
