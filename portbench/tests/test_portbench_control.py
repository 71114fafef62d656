"""``correct`` on the tiny cells on the CPU, with each cell's own limits: a
sound run passes, and so does the reference summing in another order in
the program's place; the control (the reference one precision step down
in the program's place) fails, and a run whose timed path is broken
underneath fails, once for each fault the cell can have.

On the card, the same at the cells' own sizes is ``portbench/readings.py``.
"""

import json
import sys

import pytest
import torch

from conftest import ROOT
from portbench import run as bench_run
from portbench.harness import cell as cell_lib
from portbench.harness import judge, setup
from portbench.reference.precision import CONTROL, REORDERED

CELLS = ["munich-bf16.batch8", "native-bf16.batch4", "munich-bf16.frame1",
         "munich-bf16.scenes8"]
SEED = 2 ** 31 + 3


def _cell(tiny, name):
    manifest, data = tiny
    return cell_lib.load(name, manifest, data)


def _quiet(msg):
    print(msg, file=sys.stderr)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    out, rows = bench_run.measure(_cell(tiny, name), SEED, 0.5, False, "cpu", log=_quiet)
    assert out["correct"], rows
    assert list(out)[-1] == "check" and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_reordered_reference_is_correct(tiny, name):
    """A sound program that sums in another order passes: the reference in
    the libraries' order in the program's place (the lower readings'
    witness)."""
    cell = _cell(tiny, name)
    bench = setup.build(cell, SEED, "cpu")
    bench.pipe = None
    k = int(cell.traffic["check_batches"])
    numbers = judge.compare(bench, judge.control_samples(bench, list(range(k)), REORDERED))
    correct, rows = judge.verdict(numbers, cell.limits)
    assert correct, rows


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    cell = _cell(tiny, name)
    bench = setup.build(cell, SEED, "cpu")
    bench.pipe = None
    k = int(cell.traffic["check_batches"])
    numbers = judge.compare(bench, judge.control_samples(bench, list(range(k)), CONTROL))
    correct, rows = judge.verdict(numbers, cell.limits)
    assert not correct, rows


def _traffic(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {w["name"]: w for w in spec["workloads"]}[name]
    return json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())


FAULT_CASES = [(name, fault) for name in CELLS for fault in sorted(judge.FAULTS)
               if judge.fault_applies(fault, _traffic(name))]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_broken_timed_path_is_not_correct(tiny, name, fault):
    out, rows = bench_run.measure(_cell(tiny, name), SEED, 0.5, False, "cpu", log=_quiet,
                                  broken=judge.FAULTS[fault])
    assert not out["correct"], rows


def test_every_cell_has_each_fault_it_can_have():
    """half_batch wherever a call holds two frames or more, dropped_layer
    wherever FCN-8s runs, altered everywhere."""
    assert ("munich-bf16.frame1", "half_batch") not in FAULT_CASES
    assert ("munich-bf16.scenes8", "dropped_layer") not in FAULT_CASES
    assert len(FAULT_CASES) == 3 * len(CELLS) - 2


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card():
    """A short run of the stand-in cell on the card, through the command."""
    import json
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "munich-bf16.scenes8", "--seed", str(SEED), "--seconds", "2",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
