"""The reference against the port on the CPU: whole runs of the steady
traffic under the cell's configuration and the two fixtures, cut to a small
size, and under label and taint churn."""

import re

import pytest

from conftest import CELL_CONFIG, CONFIGS, small_cell


def _run(config_name, seed, churn=False, **cut):
    from portbench import run

    bench, config, mix = small_cell(config_name, churn=churn, **cut)
    lines = []
    result = run.run_cell("twin-5k-steady", seed, 1.5, False, device="cpu",
                          bench=bench, config=config, mix=mix,
                          log=lines.append)
    return result, lines


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("config_name", CONFIGS)
def test_port_equals_reference(config_name, churn):
    result, lines = _run(config_name, 20240 + len(config_name), churn=churn)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["check"] == {"mismatched": {"value": 0, "limit": 0},
                               "undecided": {"value": 0, "limit": 0}}
    assert lines[-2:] == ["check: mismatched 0 (limit 0)",
                          "check: undecided 0 (limit 0)"]


def test_refusals_are_compared():
    """A cluster full enough that pods are refused: their FitError texts
    are compared too."""
    result, lines = _run("mixed-shapes", 77, nodes=24, population=480,
                         arrivals=24)
    refused = int(re.search(r"\((\d+) refused\)", " ".join(lines)).group(1))
    assert refused > 0
    assert result["correct"], lines


def test_end_to_end_metrics_reported():
    result, _ = _run(CELL_CONFIG, 5)
    metrics = result["metrics"]
    assert set(metrics) == {"decisions_per_s", "cycle_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in metrics.values())
    assert list(result)[-1] == "check"
