"""The controls of the comparison that decides `correct`: the reference put
in the program's place with one departure, driven through a cell's own
traffic, and compared by run.compare exactly as a run compares the program.

  first_tie  breaks the configuration's tie-break guarantee as an argmax
             would: the first of the tied nodes instead of selectHost's
             round robin;
  carry_rr   breaks it otherwise: selectHost's round-robin counter carried
             from one cycle's batch to the next instead of starting at 0
             in each;
  float64    the scores in float64 and truncated, as Go computes them,
             where the reference's are exact rationals;
  float32    one precision lower again. On scheduler-perf-5000n's shapes
             both read 0: no precision moves a score there (its file's
             note), so that configuration states none.

    python3 portbench/control.py --config <name> --traffic <name> \
        --seed <n> --cycles <k> [--control first_tie|carry_rr|float64|float32]

prints the numbers compared, and exits 0 when the control comes out not
correct. It needs no card: the controls are NumPy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


CONTROLS = {
    # the tie-break guarantee broken: the first tied node, as an argmax takes
    "first_tie": {"first_tie": True},
    # the tie-break guarantee broken: selectHost's counter carried across
    # cycles, as upstream's lastNodeIndex is
    "carry_rr": {"carry_rr": True},
    # the scores as Go computes them, in float64, where the reference's are
    # exact rationals
    "float64": {"precision": "float64"},
    # one precision lower again
    "float32": {"precision": "float32"},
}


def control_run(config: dict, mix: dict, seed: int, cycles: int,
                control: str = "first_tie") -> dict:
    """The cell's cycles decided by the reference with a control's
    departure in the program's place, then judged against the reference:
    the numbers compared, as a run reports them."""
    from portbench import generator
    from portbench.reference.scheduler import ReferenceScheduler
    from portbench.run import DecisionLog, compare

    inputs = generator.make_inputs(config, seed)

    def new_traffic():
        return generator.Traffic(config, mix, inputs.nodes, seed,
                                 {p.name: 1 for p in inputs.population})

    stand_in = ReferenceScheduler(config, inputs.nodes, **CONTROLS[control])
    for p, j in zip(inputs.population, inputs.placed_on):
        stand_in.bind(p, j)
    traffic = new_traffic()
    log = DecisionLog()
    for _ in range(mix["warmup_cycles"] + cycles):
        c = traffic.next_cycle()
        for name in c.evict:
            stand_in.evict(name)
        for i, labels in c.relabel:
            stand_in.relabel(i, labels)
        for i, taints in c.retaint:
            stand_in.retaint(i, taints)
        decided = stand_in.schedule_cycle(c.arrivals)
        traffic.note_bound([p.name for p, (node, _m) in
                            zip(c.arrivals, decided) if node])
        log.add(decided)
    reference = ReferenceScheduler(config, inputs.nodes)
    for p, j in zip(inputs.population, inputs.placed_on):
        reference.bind(p, j)
    verdict = compare(reference, new_traffic(), log)
    return {"mismatched": verdict["mismatched"],
            "undecided": verdict["undecided"],
            "decisions": len(log.nodes),
            "first": verdict["first"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cycles", type=int, required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS), default="first_tie")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import load_data

    config = load_data("configs", args.config)
    mix = load_data("traffic", args.traffic)
    out = control_run(config, mix, args.seed, args.cycles, args.control)
    print(json.dumps({"config": args.config, "traffic": args.traffic,
                      "seed": args.seed, "control": args.control, **out}))
    return 0 if out["mismatched"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
