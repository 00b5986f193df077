"""Chaos and durability on the card against the same runs on the CPU
(tolerance 0): the device breaker in front of the fused kernel and the scan
route, a stream under device faults, and the checkpoint's device image of a
pipelined run against a synchronous run's.

This file imports only torch and the port, so it also runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_chaos_cuda.py

Without a card every case skips.
"""

import os

import numpy as np
import pytest
import torch

from tpusim_torch import workloads as W
from tpusim_torch.backend import TorchBackend, install_chaos, uninstall_chaos
from tpusim_torch.backends import placement_hash
from tpusim_torch.chaos.plan import DeviceFaultPlan, FaultPlan
from tpusim_torch.kernels.fastscan import fastscan_chunk
from tpusim_torch.simulator import run_simulation, run_stream_simulation
from tpusim_torch.stream.persist import StreamPersistence


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def _no_chaos_seam():
    uninstall_chaos()
    yield
    uninstall_chaos()


def split(status):
    return ([(p.name, p.spec.node_name) for p in status.successful_pods],
            [(p.name, p.status.conditions[-1].message)
             for p in status.failed_pods], status.stop_reason)


def device_plan(verify, faults=None):
    return FaultPlan(seed=0, device=DeviceFaultPlan(
        faults=faults or {0: "corrupt_silent", 1: "exception",
                          2: "corrupt_invalid"},
        failure_threshold=1, cooldown=1, verify=verify))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("verify", ["all", "probe"])
def test_cuda_breaker_matches_cpu(route, verify):
    need_card()
    got = {}
    for device in ("cuda", "cpu"):
        snapshot, pods = W.build_workload(700, 300, seed=31)
        got[device] = run_simulation(pods, snapshot, backend="torch",
                                     device=device, route=route,
                                     chaos_plan=device_plan(verify))
    assert split(got["cuda"]) == split(got["cpu"])
    assert got["cuda"].chaos_summary == got["cpu"].chaos_summary


@pytest.mark.cuda
def test_cuda_breaker_launches_only_when_allowed():
    """Dispatch by dispatch: a fault raises before any launch, a denied
    dispatch launches nothing, every other dispatch launches the kernel;
    every answer equals the host's."""
    need_card()
    snapshot, pods = W.uniform_workload(1_000, 100)
    want = placement_hash(TorchBackend(device="cpu", route="kernel")
                          .schedule(pods, snapshot))
    breaker = install_chaos(DeviceFaultPlan(
        faults={0: "exception", 1: "corrupt_invalid", 3: "corrupt_silent"},
        failure_threshold=2, cooldown=1, verify="all"))
    backend = TorchBackend(device="cuda", route="kernel")
    launches = []
    for _ in range(6):
        fastscan_chunk.launches = 0
        assert placement_hash(backend.schedule(pods, snapshot)) == want
        launches.append(fastscan_chunk.launches)
    assert [t for t, _ in breaker.transitions] == ["open", "half_open",
                                                   "close"]
    assert [n > 0 for n in launches] == [False, True, False, True, True,
                                         True]


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_cuda_stream_chaos_matches_cpu(pipeline):
    need_card()
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = run_stream_simulation(
            num_nodes=300, cycles=12, arrivals=24, seed=7, device=device,
            pipeline=pipeline, chaos_plan=device_plan(
                "probe", {2: "exception", 5: "corrupt_invalid",
                          8: "corrupt_silent"}))
    for key in ("fold_chain", "placement_chain", "paths", "restages",
                "breaker_transitions"):
        assert out["cuda"][key] == out["cpu"][key], key


def _images(tmp_path, pipeline, monkeypatch):
    """Every checkpoint's device image of one run, in order."""
    images = []
    real = StreamPersistence.checkpoint

    def keep(self):
        meta = real(self)
        if meta["device_npz"]:
            with np.load(os.path.join(self.directory,
                                      meta["device_npz"])) as z:
                images.append({k: z[k].copy() for k in z.files})
        return meta

    monkeypatch.setattr(StreamPersistence, "checkpoint", keep)
    out = run_stream_simulation(
        num_nodes=400, cycles=9, arrivals=32, seed=3, device="cuda",
        pipeline=pipeline, checkpoint_dir=str(tmp_path / str(pipeline)),
        checkpoint_every=1)
    monkeypatch.setattr(StreamPersistence, "checkpoint", real)
    return out, images


@pytest.mark.cuda
def test_cuda_pipelined_checkpoint_image(tmp_path, monkeypatch):
    """A pipelined checkpoint is cut while the next cycle's scan may still
    run: its copy of the carry must wait for that scan. So each image is a
    carry the synchronous run checkpointed too, at the same emission or one
    later (the carry after the scan in flight), never a half-written one;
    some are one later, and the last images (no cycle in flight) are
    equal."""
    need_card()
    sync, sync_images = _images(tmp_path, False, monkeypatch)
    pipe, pipe_images = _images(tmp_path, True, monkeypatch)
    assert sync["fold_chain"] == pipe["fold_chain"]
    assert len(sync_images) == len(pipe_images) >= 9

    def carry(image):
        return {k: v for k, v in image.items() if k.startswith("carry_")}

    def equal(a, b):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                            for k in a)

    ahead = 0
    for k, image in enumerate(pipe_images):
        here = equal(carry(image), carry(sync_images[k]))
        later = (k + 1 < len(sync_images)
                 and equal(carry(image), carry(sync_images[k + 1])))
        assert here or later, f"image {k} is no carry the sync run had"
        ahead += later and not here
    assert ahead > 0
    for name, value in pipe_images[-1].items():
        np.testing.assert_array_equal(value, sync_images[-1][name],
                                      err_msg=name)
