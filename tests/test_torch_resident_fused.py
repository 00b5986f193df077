"""The resident scan's two routes, on the CPU (tpusim_torch/scan.py
ResidentScan, tpusim_torch/kernels/resident_step.py): which configurations
take the fused step, the route every twin takes here, the launch the
wrapper builds against the kernel's entry point, and the build of a single
CUDA source. The kernel itself runs on the card only
(tests/test_torch_resident_fused_cuda.py).

- fused_step_eligible admits a CUDA, unsharded, policy-free, group-free
  configuration, and refuses each pod-group feature, a policy, a shard, the
  CPU, more scalar resources than the kernel's reason word holds and more
  nodes than a portable cluster's shared memory holds.
- launch_geometry cuts the node axis into slabs of whole lane groups, and
  refuses a slab past a CTA's shared memory.
- On the CPU every twin's programs take route "torch_step": no bucket runs
  fused, every device_dispatch span says "torch_step", and the chains are
  the JAX package's.
- The resident tensors of a twin are what the kernel reads (check_operands),
  the packed pod row is laid out as the kernel's enums say, and launch_args
  gives tpusim_resident_step as many arguments, of the kinds, that
  build.SOURCES declares.
- build.load of one source compiles that source alone.
Tolerance: exact.
"""

import ctypes
import dataclasses
import json
import pathlib

import pytest
import torch

from tpusim.simulator import run_stream_simulation as jax_stream
from tpusim_torch import scan
from tpusim_torch.api.snapshot import make_pod, synthetic_cluster
from tpusim_torch.config import EngineConfig
from tpusim_torch.engine.policy import decode_policy
from tpusim_torch.kernels import build
from tpusim_torch.kernels import resident_step as rs
from tpusim_torch.obs import recorder as flight
from tpusim_torch.policyc import compile_policy
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream import ChurnLoadGen, StreamSession

POLICY = compile_policy(decode_policy(json.loads(
    (pathlib.Path(__file__).parent / "compat_policies.json").read_text()
)["1.0"])).spec
SHARD = scan.Shard(group=None, rank=0, size=2, n_local=4, base=0)
GROUP_FLAGS = ("has_ports", "has_services", "has_interpod",
               "has_disk_conflict", "has_maxpd", "has_vol_zone")
NO_FEATURE = EngineConfig()


@pytest.mark.parametrize("case,eligible", [
    ("group_free", True), ("most_requested", True),
    *((flag, False) for flag in GROUP_FLAGS),
    ("policy", False), ("shard", False), ("cpu", False),
    ("scalars", False), ("max_nodes", True), ("nodes", False)])
def test_fused_step_eligible(case, eligible):
    config, shard, device, n_nodes, n_scal = NO_FEATURE, None, "cuda", 5000, 2
    if case == "most_requested":
        config = dataclasses.replace(config, most_requested=True)
    elif case in GROUP_FLAGS:
        config = dataclasses.replace(config, **{case: True})
    elif case == "policy":
        config = dataclasses.replace(config, policy=POLICY)
    elif case == "shard":
        shard = SHARD
    elif case == "cpu":
        device = "cpu"
    elif case == "scalars":
        n_scal = rs.MAX_SCALARS + 1
    elif case == "max_nodes":
        n_nodes = rs.MAX_NODES
    elif case == "nodes":
        n_nodes = rs.MAX_NODES + 1
    assert scan.fused_step_eligible(config, shard, torch.device(device),
                                    n_nodes, n_scal) is eligible


def _twin():
    """A warm CPU twin of 12 nodes: its resident tensors and one program."""
    session = StreamSession(synthetic_cluster(12), device="cpu")
    gen = ChurnLoadGen(synthetic_cluster(12), seed=3, arrivals=8,
                       evict_fraction=0.25)
    for c in range(3):
        session.apply_events(gen.events(c))
        gen.note_bound(session.schedule(gen.batch()))
    return session


def test_cpu_twin_takes_the_torch_step_and_keeps_the_jax_chains():
    before = scan.fused_buckets()
    rec = flight.install(flight.FlightRecorder())
    try:
        kw = dict(num_nodes=8, arrivals=8, cycles=6, seed=4)
        got = run_stream_simulation(device="cpu", **kw)
        pipelined = run_stream_simulation(device="cpu", pipeline=True, **kw)
    finally:
        flight.uninstall()
    want = jax_stream(**kw)
    for key in ("placement_chain", "fold_chain", "paths", "restages"):
        assert got[key] == want[key], key
    assert pipelined["fold_chain"] == want["fold_chain"]
    routes = [e["args"].get("route") for e in rec.events
              if e["name"] == "device_dispatch" and e.get("ph") == "X"]
    assert routes and set(routes) == {"torch_step"}
    assert scan.fused_buckets() == before
    session = _twin()
    assert {p.route for p in session.device._programs.values()} == \
        {"torch_step"}
    assert session.device.last_route == "torch_step"


def test_overlay_scan_span_names_the_route():
    session = _twin()
    query = [make_pod(f"q{i}", milli_cpu=300, memory=2**28) for i in range(3)]
    rec = flight.install(flight.FlightRecorder())
    try:
        assert session.overlay_query(query) is not None
    finally:
        flight.uninstall()
    [span] = [e for e in rec.events
              if e["name"] == "overlay_scan" and e.get("ph") == "X"]
    assert span["args"]["route"] == "torch_step"


def test_twin_tensors_are_what_the_kernel_reads():
    session = _twin()
    dev = session.device
    [program] = list(dev._programs.values())
    rs.check_operands(dev.statics, dev.carry, program.pods, program.out,
                      program._steps.t1)
    n_scal = dev.statics.alloc_scalar.shape[-1]
    at, width = scan._pod_layout(n_scal)
    assert width == len(rs.POD_HEAD) + n_scal + len(rs.POD_TAIL)
    for k, name in enumerate(rs.POD_HEAD):
        assert at[name] == (k, 1)
    assert at["req_scalar"] == (len(rs.POD_HEAD), n_scal)
    for k, name in enumerate(rs.POD_TAIL):
        assert at[name] == (len(rs.POD_HEAD) + n_scal + k, 1)
    with pytest.raises(ValueError, match="int64"):
        rs.check_operands(dev.statics._replace(
            alloc_cpu=dev.statics.alloc_cpu.to(torch.int32)), dev.carry,
            program.pods, program.out, program._steps.t1)
    with pytest.raises(ValueError, match="CUDA"):
        rs.make_fused_step(dev.config, dev.statics, program.pods, dev.carry,
                           program.out, program._steps.t1)


@pytest.mark.parametrize("n,cluster,threads,slab", [
    (5000, 16, 320, 320), (4, 1, 32, 32), (100, 4, 32, 32),
    (40_000, 16, 512, 2528), (rs.MAX_NODES, 8, 512, rs.MAX_SLAB)])
def test_launch_args_match_the_entry_point(n, cluster, threads, slab):
    session = _twin()
    dev = session.device
    [program] = list(dev._programs.values())
    geom = rs.launch_geometry(n, cluster)
    assert (geom.cluster, geom.threads, geom.slab) == (cluster, threads, slab)
    assert geom.smem == 16 * slab
    args = rs.launch_args(dev.config, dev.statics, dev.carry, program.pods,
                          program.out, program._steps.t1, geom, stream=12345)
    argtypes = build.SOURCES["resident_step.cu"]["tpusim_resident_step"]
    assert len(args) == len(argtypes)
    for arg, kind in zip(args, argtypes):
        if kind is ctypes.c_void_p:
            assert arg is None or isinstance(arg, int)
        else:
            assert kind is ctypes.c_int and isinstance(arg, int)
            assert -2**31 <= arg < 2**31
    assert args[-1] == 12345 and args[1] == program.pods.shape[1]
    assert args[-4:-1] == (geom.cluster, geom.threads, geom.smem)


@pytest.mark.parametrize("n,cluster", [
    (rs.MAX_NODES + 1, 8), (rs.MAX_NODES, 4), (2 * rs.MAX_NODES + 1, 16),
    (0, 1), (64, 4), (5000, 3)])
def test_launch_geometry_refuses(n, cluster):
    with pytest.raises(ValueError, match="cluster of"):
        rs.launch_geometry(n, cluster)


def test_load_builds_only_the_source_it_loads(tmp_path, monkeypatch):
    built = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            built.append(pathlib.Path(cmd[-1]).name)
            pathlib.Path(out).write_bytes(b"")

        def communicate(self):
            return "", None

    class Lib:
        def __getattr__(self, name):
            fn = lambda *a: 0   # noqa: E731
            setattr(self, name, fn)
            return fn

    def no_build_all(*a, **kw):
        raise AssertionError("build_all compiles every source")

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build_all", no_build_all)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    build.load("resident_step.cu")
    assert built == ["resident_step.cu"]
    build.load("resident_step.cu")
    assert built == ["resident_step.cu"]
    build.load("fastscan.cu")
    assert built == ["resident_step.cu", "fastscan.cu"]
