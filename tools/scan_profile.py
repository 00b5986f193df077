#!/usr/bin/env python3
"""Where the exact sequential scan's time goes on one NVIDIA GPU: the scan
of tpusim_torch/scan.py on the first pods of chip_smoke.py's workloads,
eagerly (one kernel launch an operation) and with blocks of steps replayed
as CUDA graphs, then one short eager run under torch.profiler.

    python3 tools/scan_profile.py [hostname config3 ...] [--pods N]

Prints, per workload: the wall, the device span (CUDA events) and
microseconds a pod for each block size (0 = eager), every run checked equal
to the eager one; the kernel launches and device time a pod under the
profiler, against the host time a pod of the eager run, which gives the
card's idle share while the scan runs eagerly; and the operations that take
the most device time.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BUILDS = {"hostname": ("hostname_workload", 5_000),
          "config3": ("build_workload", 5_000)}
BLOCKS = (0, 8, 32, 128)
PROFILED_PODS = 50


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def device_time(event):
    """An averaged profiler event's device self time, µs, under either
    name torch has given it."""
    t = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if t is None else t


def main(argv):
    import torch

    from tpusim_torch import workloads
    from tpusim_torch.backend import compile_inputs
    from tpusim_torch.scan import scan_inputs, schedule_scan

    parser = argparse.ArgumentParser()
    parser.add_argument("names", nargs="*", default=sorted(BUILDS))
    parser.add_argument("--pods", type=int, default=2_000)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    card = card_line()
    for name in args.names:
        workload, nodes = BUILDS[name]
        snapshot, pods = getattr(workloads, workload)(args.pods, nodes)
        config, compiled, cols, ptabs = compile_inputs(snapshot, pods)
        carry, statics, xs = scan_inputs(config, compiled, cols, ptabs, cuda)
        want = None
        eager_us = None
        for graph_steps in BLOCKS:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = schedule_scan(config, carry, statics, xs,
                                graph_steps=graph_steps)
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = [t.cpu() for t in (*out[0], *out[1:])]
            want = want or got
            same = all(torch.equal(a, b) for a, b in zip(want, got))
            us = 1e6 * wall / args.pods
            eager_us = eager_us or us
            print(f"{name} ({args.pods} pods, {nodes} nodes): graph_steps "
                  f"{graph_steps}: wall {wall:.3f}s, device span "
                  f"{start.elapsed_time(end):.1f} ms (CUDA events), {us:.0f} "
                  f"us a pod, equal to eager {same} on {card}", flush=True)
            if not same:
                raise AssertionError(f"{name}: graph_steps {graph_steps} "
                                     "placed differently")
        part = type(xs)(*(col[:PROFILED_PODS] for col in xs))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            schedule_scan(config, carry, statics, part)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(device_time(e) for e in kernels)
        launches = sum(e.count for e in kernels)
        per_pod = device_us / PROFILED_PODS
        print(f"{name}: profiler over {PROFILED_PODS} eager steps: "
              f"{launches / PROFILED_PODS:.0f} kernels and {per_pod:.0f} us "
              f"of device time a pod; against {eager_us:.0f} us a pod eager, "
              f"the card is idle {100 * (1 - per_pod / eager_us):.0f}% of "
              f"an eager scan", flush=True)
        print(events.table(sort_by="self_cuda_time_total", row_limit=12),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
