#!/usr/bin/env python3
"""Where a pod's time goes inside the fast-scan CUDA kernel, on one NVIDIA
GPU: a copy of tpusim_torch/csrc/fastscan.cu with clock64() counters at the
kernel's phase boundaries (thread 0 of each CTA sums the cycles of each
phase over the chunk's pods) is built apart, under
tpusim_torch/_build/profile/, and run on the first 512-pod chunk of
chip_smoke.py's full-size workloads. Prints, per workload and cluster size,
the mean cycles a pod of each phase over the CTAs, and the SM clock.

    python3 tools/fastscan_profile.py [config3 policy ...]

The phases: setup (the pod's operands, the inter-pod phase), pass 1 and the
push of the CTA's values, the wait at cluster barrier 1, the gather of the
cluster's totals, pass 2 (or the histogram) and the push of the CTA's
(max, ties), the wait at cluster barrier 2, the tie pick and bind, the wait
at cluster barrier 3, and the pod's tail. A phase that ends at a barrier
includes the wait for the slowest thread of the cluster. The counters cost
a clock read and an add a phase, on one thread of each CTA.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PHASES = ("setup", "pass 1 + push", "barrier 1", "gather", "pass 2 + push",
          "barrier 2", "pick + bind", "barrier 3", "tail")
SIZES = {"config3": (16, 4, 1), "policy": (16, 4, 1)}


def count(k):
    return (f"    if (tid == 0) {{ long long now_ = clock64(); "
            f"pacc[{k}] += now_ - plast; plast = now_; }}\n")


def patched_source(src):
    """The kernel with the phase counters and a reader of them."""
    def put(anchor, text, after=False):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"fastscan.cu changed: anchor {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n", "__device__ long long g_prof[16][10];\n", after=True)
    loop = "  for (int j = 0; j < a.k; ++j) {\n"
    put(loop, "  long long pacc[10] = {};\n  long long plast = clock64();\n")
    put(loop, count(8), after=True)
    put("    // pass 1 over my nodes", count(0))
    b1 = ("    // cluster barrier 1: every CTA's pass-1 values are in every "
          "inbox\n    cluster.sync();\n")
    put(b1, count(1))
    put(b1, count(2), after=True)
    put("    if (nf > 0) {\n      // pass 2", count(3))
    b2 = ("      // cluster barrier 2: every CTA's pair is in every CTA\n"
          "      cluster.sync();\n")
    put(b2, count(4))
    put(b2, count(5), after=True)
    put("      // cluster barrier 3, only where", count(6))
    put("      if (kInterpod || lock_bind) cluster.sync();\n", count(7),
        after=True)
    b2h = ("      // cluster barrier 2: every CTA's histogram is in rank 0; "
           "rank 0 sums\n      // them in rank order\n      cluster.sync();\n")
    put(b2h, count(4))
    put(b2h, count(5), after=True)
    put("  // no CTA exits while another can still read its shared memory\n",
        "  if (tid == 0)\n    for (int q = 0; q < 10; ++q) "
        "g_prof[rank][q] = pacc[q];\n")
    return src + ('\nextern "C" int tpusim_prof_read(long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_prof, '
                  'sizeof(g_prof));\n}\n')


def main(names):
    import torch

    if not torch.cuda.is_available():
        print("fastscan_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tpusim_torch import workloads
    from tpusim_torch.fastscan import CHUNK
    from tpusim_torch.kernels import build
    from tpusim_torch.kernels.fastscan import fastscan_chunk

    out_dir = os.path.join(build.BUILD_DIR, "profile")
    os.makedirs(os.path.join(out_dir, "csrc"), exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "fastscan.cu")) as f:
        src = patched_source(f.read())
    with open(os.path.join(out_dir, "csrc", "fastscan.cu"), "w") as f:
        f.write(src)
    build.CSRC_DIR = os.path.join(out_dir, "csrc")
    build.BUILD_DIR = out_dir
    lib = build.load("fastscan.cu")
    cuda = torch.device("cuda")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card, power limit, max SM clock: {clocks}")
    for name in names or cs.GOLDENS:
        workload, params, *_ = cs.GOLDENS[name]
        policy = (workloads.COMPAT_POLICIES[cs.POLICY[name]]
                  if name in cs.POLICY else None)
        snapshot, pods = getattr(workloads, workload)(**params)
        plan = cs.make_plan(snapshot, pods, False, policy)
        for c in SIZES.get(name, (16,)):
            ms, _ = cs.chunk_run(fastscan_chunk, plan, cuda, 3, c)
            buf = (ctypes.c_longlong * 160)()
            if lib.tpusim_prof_read(buf) != 0:
                raise RuntimeError("reading the counters failed")
            k = min(plan.num_pods, CHUNK)
            per = [sum(buf[r * 10 + q] for r in range(c)) / c / k
                   for q in range(len(PHASES))]
            print(f"{name}, {c} CTA(s): {ms:.3f} ms a chunk with counters; "
                  "cycles a pod: " + ", ".join(
                      f"{p} {v:.0f}" for p, v in zip(PHASES, per))
                  + f"; total {sum(per):.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
