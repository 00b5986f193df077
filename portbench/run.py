"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`: a configuration
(portbench/configs/<config>.json) under a traffic mix
(portbench/traffic/<traffic>.json). The run builds the cluster, its standing
population and its churn from the seed, stands up the port's streaming twin
on the card, warms it up, then runs cycles back to back for `--seconds`: each
cycle hands the twin its watch events and its arrivals
(StreamSession.apply_events, then StreamSession.schedule). With --trace 0 it
reports the cell's end-to-end metrics; with --trace 1 the per-layer metrics,
each read by portbench/metrics/<metric>.py from the program's spans and
counters and a torch.profiler stretch.

Once the window has closed, every decision of the run is compared with
portbench/reference's NumPy scheduler, which folds the same events into
node state of its own: `correct` holds where none differs. The last line of
standard output is the result, one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded in the process that prints the
# result: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusim")
PROFILED_CYCLES = 6      # cycles of a traced window under torch.profiler
PROFILE_AFTER = 4        # window cycles before the profiled stretch


def _pin_environment() -> None:
    """Caches inside the checkout at fixed paths, so that only a cell's
    first run there builds anything, and one thread a library."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_data(kind: str, name: str) -> dict:
    """portbench/<kind>/<name>.json: a configuration or a traffic mix."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def load_cell(name: str, bench: dict, root: str = ROOT):
    """(workload entry, configuration, traffic mix) of a cell, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    return cell, config, load_data("traffic", cell["traffic"])


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile of every sample, linearly interpolated between
    the closest ranks (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("no samples")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def load_reader(metric: str):
    """portbench/metrics/<metric>.py's read(readings)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Readings:
    """What the per-layer readers read, over the window."""

    spans: List[dict] = field(default_factory=list)
    cycles: int = 0
    cycle_walls_s: List[float] = field(default_factory=list)
    restages: Optional[Dict[str, int]] = None
    profile: Optional[dict] = None
    step_bytes: Optional[int] = None
    peak: Optional[dict] = None


def _card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _profile_events(prof) -> List[dict]:
    """The profiler's Chrome trace events, through a file under TMPDIR."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


class DecisionLog:
    """The program's decisions, kept flat so that a long window adds one
    list and no objects for the collector to walk: each pod's node name
    (the program's own string) or "" with its FitError text by position,
    and the pods a cycle."""

    def __init__(self):
        self.nodes: List[str] = []
        self.messages: Dict[int, str] = {}
        self.sizes: List[int] = []

    def add(self, decisions) -> None:
        """decisions: (node name or "", FitError text) a pod, in order."""
        for node, message in decisions:
            if not node:
                self.messages[len(self.nodes)] = message
            self.nodes.append(node)
        self.sizes.append(len(decisions))

    def cycles(self):
        """Each cycle's [(node, FitError text)], in order."""
        at = 0
        for size in self.sizes:
            yield [(self.nodes[i], self.messages.get(i, ""))
                   for i in range(at, at + size)]
            at += size


def compare(reference, traffic, log: DecisionLog) -> Dict[str, int]:
    """Replay the run's inputs through the reference and count the
    decisions that differ: a bound pod's node, a refused pod's FitError
    text, or a pod the program gave no decision. `traffic` is a fresh
    Traffic of the run's seed: fed the program's binds, it draws the run's
    cycles again."""
    mismatched = undecided = 0
    first = None
    for cycle_no, decisions in enumerate(log.cycles()):
        c = traffic.next_cycle()
        for name in c.evict:
            reference.evict(name)
        for i, labels in c.relabel:
            reference.relabel(i, labels)
        for i, taints in c.retaint:
            reference.retaint(i, taints)
        want = reference.schedule_cycle(c.arrivals)
        if len(decisions) != len(want):
            undecided += abs(len(want) - len(decisions))
        for pod, got, exp in zip(c.arrivals, decisions, want):
            if got != exp:
                mismatched += 1
                if first is None:
                    first = (cycle_no, pod.name, got, exp)
        traffic.note_bound([pod.name for pod, (node, _m) in
                            zip(c.arrivals, decisions) if node])
    return {"mismatched": mismatched, "undecided": undecided, "first": first}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Optional[dict] = None,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             log=None) -> dict:
    """One run of a cell: set-up, warm-up, the window, the readings and the
    comparison; returns the result object. `config` and `mix` replace the
    cell's files (the tests run small cells on the CPU); `log` receives the
    lines meant for standard error."""
    import torch

    from portbench import generator, roofline
    from portbench.program import Twin
    from portbench.reference.scheduler import ReferenceScheduler
    from portbench.trace import read_profile, recorder_spans

    say = log or (lambda line: print(line, file=sys.stderr, flush=True))
    bench = load_bench() if bench is None else bench
    cell, cfg_file, mix_file = load_cell(workload, bench)
    config = cfg_file if config is None else config
    mix = mix_file if mix is None else mix
    if seed < 0:
        raise SystemExit("portbench: --seed must be a whole number >= 0")
    on_cuda = device == "cuda"

    # -- set-up ----------------------------------------------------------
    marks = [("imports", time.perf_counter())]
    inputs = generator.make_inputs(config, seed)
    marks.append(("inputs", time.perf_counter()))
    twin = Twin(config, inputs, device)
    marks.append(("twin", time.perf_counter()))

    def new_traffic():
        return generator.Traffic(config, mix, inputs.nodes, seed,
                                 {p.name: 1 for p in inputs.population})

    traffic = new_traffic()
    decisions = DecisionLog()

    def cycle(record=None):
        c = traffic.next_cycle()
        events, pods = twin.prepare(c)
        t0 = time.perf_counter()
        placements = twin.run_cycle(events, pods)
        if record is not None:
            record.append(time.perf_counter() - t0)
        traffic.note_bound(twin.note(placements))
        decisions.add([(pl.node_name, "" if pl.node_name else pl.message)
                       for pl in placements])
        return len(placements)

    cycle()
    marks.append(("cold start", time.perf_counter()))
    for _ in range(mix["warmup_cycles"] - 1):
        cycle()
    marks.append(("warm-up", time.perf_counter()))
    if trace and on_cuda:
        # the profiler's first start loads CUPTI: pay it in set-up
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            cycle()
        marks.append(("profiler", time.perf_counter()))
    if on_cuda:
        torch.cuda.synchronize()
    session = twin.session
    restages_before = dict(session.restage_counts)
    paths_before = dict(session.path_counts)
    rec = None
    if trace:
        from tpusim_torch.obs import recorder

        rec = recorder.install(recorder.FlightRecorder())

    # -- the window ------------------------------------------------------
    walls: List[float] = []
    decided = 0
    first_window = len(decisions.sizes)
    first_pod = len(decisions.nodes)
    prof = None
    profiled = 0
    w0 = time.perf_counter()
    setup_s = w0 - T_START
    say("portbench: set-up " + ", ".join(
        f"{name} {b - a:.3f} s" for (_n, a), (name, b) in
        zip([("start", T_START)] + marks, marks)))
    deadline = w0 + seconds
    w1 = w0
    while w1 < deadline:
        n_cycle = len(walls)
        if trace and on_cuda and n_cycle == PROFILE_AFTER:
            # device activity alone (host tracing would slow the cycles it
            # measures), between two marker launches on an idle card, so
            # the first and last device operations bound the stretch
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            marker = torch.zeros(1, device=device)
        decided += cycle(walls)
        if prof is not None and (
                n_cycle == PROFILE_AFTER + PROFILED_CYCLES - 1):
            marker.add_(1)
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            profiled = n_cycle + 1 - PROFILE_AFTER
        w1 = time.perf_counter()
    window_s = w1 - w0
    if prof is not None and len(walls) < PROFILE_AFTER + PROFILED_CYCLES:
        marker.add_(1)
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        profiled = len(walls) - PROFILE_AFTER
    if on_cuda:
        torch.cuda.synchronize()

    # -- readings --------------------------------------------------------
    result_device = {"platform": "gpu" if on_cuda else "cpu",
                     "kind": (torch.cuda.get_device_name(0) if on_cuda
                              else "cpu"),
                     "count": 1,
                     "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                           if on_cuda else 0)}
    restages = {k: v - restages_before.get(k, 0)
                for k, v in session.restage_counts.items()
                if v - restages_before.get(k, 0)}
    paths = {k: v - paths_before.get(k, 0)
             for k, v in session.path_counts.items()
             if v - paths_before.get(k, 0)}
    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    breakdown = None
    if not trace:
        values = {"decisions_per_s": decided / window_s,
                  "cycle_p95_ms": percentile(walls, 95) * 1e3,
                  "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        from tpusim_torch.obs import recorder

        spans = recorder_spans(rec)
        dropped = rec.dropped
        recorder.uninstall()
        if dropped:
            raise RuntimeError(f"the flight recorder dropped {dropped} events")
        r = Readings(spans=spans, cycles=len(walls), cycle_walls_s=walls,
                     restages=restages)
        if prof is not None:
            r.profile = read_profile(_profile_events(prof))
        r.peak = roofline.PEAKS.get(result_device["kind"])
        dev = session.device
        if dev.statics is not None:
            program = next(iter(dev._programs.values()), None)
            if program is not None:
                pod_row = program.pods[0]
                out_bytes = sum(int(t[0].numel()) * int(t.element_size())
                                for t in program.out)
                r.step_bytes = roofline.step_bytes(dev.statics, dev.carry,
                                                   pod_row, out_bytes)
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = load_reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        if r.profile is not None:
            result_device["busy_s"] = r.profile["busy_s"]
            result_device["window_s"] = r.profile["window_s"]
            breakdown = {"device_ops": r.profile["device_ops"],
                         "idle_gaps": r.profile["idle_gaps"]}
            say(f"portbench: profiled {profiled} cycles: "
                f"{r.profile['kernels']} kernels, busy {r.profile['busy_s']} s "
                f"of {r.profile['window_s']} s")
        if r.step_bytes:
            say(f"portbench: a scan step moves at least {r.step_bytes} bytes")
        if on_cuda:
            say(f"portbench: card and power limit: {_card_power_limit()}")
    refused = sum(1 for i in decisions.messages if i >= first_pod)
    say(f"portbench: {workload} seed {seed}: {len(walls)} cycles, "
        f"{decided} decisions ({refused} refused) in {window_s} s, set-up "
        f"{setup_s} s, restages {restages or 0}, paths {paths}")
    say(f"portbench: a cycle {1e3 * sum(walls) / len(walls)} ms on average")

    # -- correctness, once the window has closed -------------------------
    attempted = len(walls) * mix["arrivals"]
    del twin, session, traffic
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = ReferenceScheduler(config, inputs.nodes)
    for p, j in zip(inputs.population, inputs.placed_on):
        reference.bind(p, j)
    verdict = compare(reference, new_traffic(), decisions)
    say(f"portbench: the reference decided {len(decisions.nodes)} pods in "
        f"{time.perf_counter() - t_ref} s")
    if verdict["first"] is not None:
        say(f"portbench: first difference (cycle, pod, program, reference): "
            f"{verdict['first']}")
    failed = attempted - sum(decisions.sizes[first_window:])
    check = {"mismatched": {"value": verdict["mismatched"], "limit": 0},
             "undecided": {"value": verdict["undecided"], "limit": 0}}
    correct = all(v["value"] <= v["limit"] for v in check.values())
    for name, v in check.items():
        say(f"check: {name} {v['value']} (limit {v['limit']})")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    return result


def loaded_forbidden() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_environment()
    sys.path.insert(0, ROOT)
    bench = load_bench()
    cell, _config, _mix = load_cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} cards wanted, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
