#!/usr/bin/env python3
"""The resident scan's step on one NVIDIA GPU, on both routes: the fused
step (csrc/resident_step.cu, one launch a step) and the torch step
(scan.make_step), each over its own copy of the resident tensors of the
`twin-5k-steady` cluster (workloads.scheduler_perf_workload: 5,000 nodes,
150,000 Running pods).

    python3 tools/resident_step_profile.py [--reps 20]

Builds the kernel with ptxas's report (registers, spills), then prints for
each route: the microseconds a step of a bucket of 64 replayed from its
CUDA graph (CUDA events around the replay, the median of --reps), the same
launched eagerly, the fused step at each cluster size the kernel takes,
and the device operations a step under torch.profiler. Every bucket of the
two routes is checked equal, outputs and carry (chip_smoke.routes_diff).
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv):
    import torch

    import chip_smoke as cs
    from tpusim_torch import workloads
    from tpusim_torch.kernels import build
    from tpusim_torch.kernels.resident_step import (
        CLUSTER_SIZES,
        launch_geometry,
    )

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("resident_step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    print(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    build.build(["resident_step.cu"], verbose=True)

    bucket = cs.RESIDENT_BUCKET
    snapshot, pods = workloads.scheduler_perf_workload(bucket)
    config, routes, [rows] = cs.step_routes(snapshot, pods, cuda)
    # the pods bound by each run stay: the nodes fill by 64 a rep, far
    # below their 110-pod limit
    for rep in range(args.reps + 1):
        diff = cs.routes_diff(routes, rows)
        assert diff == 0, f"the routes differ by {diff}"
    for route, program in routes.items():
        us = 1e3 * cs.replayed_ms(program, rows, args.reps)
        print(f"{route}: {us:.2f} us a step replayed (median of {args.reps} "
              f"buckets of {bucket}), every bucket equal across the routes")

    # eager: the same step launched from Python, step by step
    for route, program in routes.items():
        program.run(rows)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        program.steps.t1.zero_()
        start.record()
        for _ in range(bucket):
            program.step()
        end.record()
        torch.cuda.synchronize()
        print(f"{route}: {start.elapsed_time(end) * 1e3 / bucket:.2f} us a "
              "step launched eagerly")

    # the fused step at each cluster size the kernel takes (the program
    # picks the largest the card schedules): replayed, us a step
    fused = routes["fused_step"]
    n = fused.statics.alloc_cpu.shape[0]
    for c in CLUSTER_SIZES:
        g = launch_geometry(n, c)
        program = cs.StepProgram("fused_step", config, fused.statics,
                                 fused.carry, bucket, geometry=g)
        us = 1e3 * cs.replayed_ms(program, rows, args.reps)
        print(f"fused_step at {g.cluster} CTA(s) x {g.threads} threads: "
              f"{us:.2f} us a step replayed")

    from torch.profiler import ProfilerActivity, profile

    for route, program in routes.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            program.run(rows)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"{route}: {len(kernels) / bucket:.2f} device operations a "
              f"step under torch.profiler (the upload's copy included)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
