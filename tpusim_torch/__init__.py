"""tpusim_torch — the Kubernetes scheduling simulator on PyTorch and CUDA.

The port of `tpusim` (JAX on a TPU) to an NVIDIA H100. It keeps tpusim's
module names so each counterpart is easy to find, and imports nothing of
tpusim or of JAX:

  api/        domain model, snapshots, podspec parsing
  engine/     the host scheduling engine (predicates, priorities, the
              generic scheduler with preemption, providers, volumes,
              extenders, cache, queues) and scheduler policies
  framework/  the store, strategy and recorder of the host orchestrator,
              and the report
  state       the numpy cluster compile (signature tables, pod columns)
  delta       IncrementalCluster: watch events folded into compiled columns,
              with the delta journal the streaming twin commits from
  config      provider configuration, a policy's compiled image, weights
  policyc     a scheduler Policy compiled to stage gating, weights and tables
  fastplan    the int32 FastPlan of the fused scan
  kernels/    the hand-written CUDA kernels, their wrappers and plain versions
  csrc/       the CUDA sources, built with nvcc at first use
  fastscan    the chunked driver of the fused scan
  scan        the exact sequential scan route (int64 tensor code), whole,
              in chunks of pods, batched over scenarios, or resident with
              in-place delta commits; the explain lanes; the gang lanes and
              packing solve; the analytics reduction
  packing     the int64 ordering keys (the top-k keys, the gang rank key)
  sharding    node-axis padding with never-feasible nodes
  whatif      run_what_if: many (snapshot, pods) scenarios in one call
  serve/      ScenarioFleet, the what-if service over batched programs
  backends    Placement, ReferenceBackend (the host route), get_backend
  backend     TorchBackend: compile -> plan -> scan -> placements
  preempt     the preemption hybrid: speculation chunks on the card, victim
              selection on the card or the host, re-arm after preemption
  gang/       pod-group annotations, feed planning, the packing oracle and
              the gang driver (all-or-nothing admission)
  stream/     the streaming twin: StreamSession, the device-resident
              cluster, the churn load generator
  simulator   ClusterCapacity (the host orchestrator), run_simulation and
              run_stream_simulation, the entry points of a simulation
  obs/        the flight recorder, decision provenance and the cluster
              analytics plane
  cli         python -m tpusim_torch.cli
"""

__version__ = "0.1.0"
