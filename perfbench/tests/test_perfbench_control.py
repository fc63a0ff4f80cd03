"""The control: the plain reference put in the program's place, in the
precision one step below the configuration's (8-bit floats for every
product's operands and result), has to read far above a sound run. At a
tiny size on the CPU, where the cells' limits (set at their own sizes on
the chip by ``calibrate.py --control``) do not carry over: one of the
numbers a cell compares reads at least three times the sound program's
there."""

import pytest
import torch

from perfbench import harness, judge
from perfbench.tests.test_perfbench_faults import SEED, TINY


@pytest.mark.parametrize("cell", ["resnet50.b256", "bert_large.s128.b128"])
def test_the_control_reads_far_above_a_sound_run(cell):
    cfg, traffic = TINY[cell]
    c = harness.Cell(cell, cfg=cfg, traffic=traffic)
    cpu = torch.device("cpu")
    sound = harness.run_rank(c, SEED, 0.2, False, device="cpu")
    ref = harness.reference_steps(c, SEED, cpu, "fp32", keep=True)
    control = harness.reference_steps(c, SEED, cpu, "fp8", keep=True)
    control["diff"] = harness.vector_diffs(control.pop("vectors"),
                                           ref.pop("vectors"), cpu)
    got = judge.compare(control, ref)
    base = judge.compare(sound["program"], sound["reference"])
    ratios = {k: got[k] / max(base[k], 1e-12) for k in c.limits if k in got}
    assert max(ratios.values()) >= 3.0, ratios


def test_the_reference_against_itself_is_correct():
    cfg, traffic = TINY["bert_large.s128.b128"]
    c = harness.Cell("bert_large.s128.b128", cfg=cfg, traffic=traffic)
    cpu = torch.device("cpu")
    a = harness.reference_steps(c, SEED, cpu, "fp32", keep=True)
    vectors = a.pop("vectors")
    a["diff"] = harness.vector_diffs(vectors, vectors, cpu)
    numbers = {**judge.compare(a, a), "window_nonfinite": 0.0}
    assert numbers["loss_gap"] == numbers["grad_gap"] == \
        numbers["change_gap"] == numbers["grad_error"] == 0.0
    assert judge.verdict(numbers, c.limits)[0]
