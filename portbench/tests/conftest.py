"""Shared helpers of the benchmark's tests: small cells on the CPU."""

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a churn mix the cells do not run, so that label and taint churn meet the
# reference too (the configuration's own label values)
CHURN = {"label_churn": 2, "taint_churn": 1,
         "label_universe": {"zone": ["z0", "z1", "z2", "z3"],
                            "region": ["r0", "r1"]},
         "churn_taint": {"key": "dedicated", "value": "batch",
                         "effect": "NoSchedule"}}


# the cell's configuration, then fixtures of this folder's configs/ that
# meet the reference's taint, label, refusal and policy paths, which the
# cell's uniform shapes do not
CELL_CONFIG = "scheduler-perf-5000n"
CONFIGS = (CELL_CONFIG, "mixed-shapes", "policy-services")


def load_config(name: str) -> dict:
    from portbench import run

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", name + ".json")
    if os.path.exists(fixture):
        with open(fixture) as f:
            return json.load(f)
    return run.load_data("configs", name)


def small_cell(config_name: str, nodes: int = 48, population: int = 700,
               arrivals: int = 16, churn: bool = False):
    """(BENCHMARK.json, config, mix) of a configuration under the steady
    traffic, cut to a size the CPU decides in seconds (with mixed-shapes,
    about 78% of the cpu taken, so that some arrivals are refused)."""
    from portbench import run

    bench = run.load_bench()
    config = copy.deepcopy(load_config(config_name))
    mix = dict(run.load_data("traffic", "steady"))
    config["cluster"]["nodes"] = nodes
    config["population"] = population
    if config["pods"].get("apps"):
        config["pods"]["apps"] = 12
    mix.update(arrivals=arrivals, evictions=arrivals, warmup_cycles=2)
    if churn:
        mix.update(CHURN)
    return bench, config, mix
