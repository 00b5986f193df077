"""The comparison that decides `correct` fails what it has to: the controls
(the reference in the program's place with the first tied node taken, or
with selectHost's counter carried across cycles), and whole runs with the
timed path broken underneath. On the cell's uniform shapes no precision
moves a score, which the precision controls show."""

import numpy as np
import pytest

from conftest import CELL_CONFIG, CONFIGS, small_cell


@pytest.mark.parametrize("control", ["first_tie", "carry_rr"])
@pytest.mark.parametrize("config_name", CONFIGS)
def test_tie_break_controls_are_not_correct(config_name, control):
    from portbench.control import control_run

    _bench, config, mix = small_cell(config_name)
    out = control_run(config, mix, seed=3, cycles=6, control=control)
    assert out["mismatched"] > 0


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_no_precision_moves_the_cell(precision):
    """scheduler-perf-5000n states no precision: with its one pod shape
    every BalancedResourceAllocation score is the same in float64 and
    float32 as in exact rationals, on every node count a node can hold."""
    from portbench.control import control_run
    from portbench.generator import PodSpec, make_inputs
    from portbench.reference.scheduler import ReferenceScheduler

    _bench, config, mix = small_cell(CELL_CONFIG)
    out = control_run(config, mix, seed=3, cycles=6, control=precision)
    assert out["mismatched"] == 0 and out["undecided"] == 0
    shape = make_inputs(dict(config, population=1), 0).population[0]
    node = make_inputs(config, 0).nodes[0]
    exact = ReferenceScheduler(config, [node])
    lower = ReferenceScheduler(config, [node], precision=precision)
    ok = np.ones(1, bool)
    for n in range(node.milli_cpu // shape.milli_cpu):
        pod = PodSpec(f"arr-{n}", shape.milli_cpu, shape.memory, False, -1)
        assert exact._balanced(pod, ok)[0] == lower._balanced(pod, ok)[0]
        exact.bind(pod, 0)
        lower.bind(pod, 0)


@pytest.mark.parametrize("precision, want", [("exact", 2), ("float64", 1),
                                             ("float32", 1)])
def test_balanced_score_precision(precision, want):
    """BalancedResourceAllocation where the fractions fall on a whole
    number: cpu 14,300m of 16,000m and memory 3,072 of 32,768 MiB give
    (1 - 0.8) x 10 = 2 exactly, which Go's float64 truncates to 1. The
    float64 control decides such ties otherwise where mixed shapes meet a
    tie."""
    from portbench.generator import NodeSpec, PodSpec
    from portbench.reference.scheduler import ReferenceScheduler

    _bench, config, _mix = small_cell("mixed-shapes")
    node = NodeSpec("node-0", 16000, 32 << 30, 110, {}, [])
    ref = ReferenceScheduler(config, [node], precision=precision)
    ref.bind(PodSpec("run-0", 10300, 2944 << 20, False, -1), 0)
    pod = PodSpec("arr-0", 4000, 128 << 20, False, -1)
    assert int(ref._balanced(pod, np.ones(1, bool))[0]) == want


def _broken_run(monkeypatch, target, replacement):
    from portbench import run

    bench, config, mix = small_cell(CELL_CONFIG)
    monkeypatch.setattr(target[0], target[1], replacement)
    return run.run_cell("twin-5k-steady", 11, 1.0, False, device="cpu",
                        bench=bench, config=config, mix=mix,
                        log=lambda line: None)


def test_commit_that_leaves_the_state_unchanged(monkeypatch):
    """The twin's commit a no-op: evictions never reach the resident
    carry."""
    from tpusim_torch.stream import runtime

    result = _broken_run(monkeypatch, (runtime, "apply_delta_"),
                         lambda *a, **k: None)
    assert not result["correct"]
    assert result["check"]["mismatched"]["value"] > 0


def test_half_of_the_batch_left_out(monkeypatch):
    from tpusim_torch.stream import runtime

    schedule = runtime.StreamSession.schedule

    def half(self, pods, _routed=None):
        return schedule(self, pods, _routed)[: len(pods) // 2]

    result = _broken_run(monkeypatch, (runtime.StreamSession, "schedule"),
                         half)
    assert not result["correct"]
    assert result["check"]["undecided"]["value"] > 0


def test_answer_altered_where_it_is_produced(monkeypatch):
    """One pod's chosen node moved to the next node as the device's choices
    are decoded."""
    from tpusim_torch.stream import runtime

    decode = runtime.StreamSession._decode

    def altered(pods, choices, counts, compiled, prebound=None):
        choices = np.array(choices, copy=True)
        n = len(compiled.statics.names)
        if choices[0] >= 0:
            choices[0] = (choices[0] + 1) % n
        return decode(pods, choices, counts, compiled, prebound)

    result = _broken_run(monkeypatch, (runtime.StreamSession, "_decode"),
                         staticmethod(altered))
    assert not result["correct"]
    assert result["check"]["mismatched"]["value"] > 0
