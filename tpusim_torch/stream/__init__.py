"""The streaming twin: the compiled cluster resident on the device across
scheduling cycles, O(delta) commits of each cycle's watch events, classified
restages where a commit cannot express them, pipelined cycles and live
what-if overlays (runtime.StreamSession), driven by seeded churn
(loadgen.ChurnLoadGen)."""

from tpusim_torch.stream.loadgen import ChurnLoadGen
from tpusim_torch.stream.persist import chain_fold
from tpusim_torch.stream.runtime import (
    MIN_BUCKET,
    DeviceResidentCluster,
    StreamSession,
    bucket_size,
)

__all__ = [
    "MIN_BUCKET",
    "ChurnLoadGen",
    "DeviceResidentCluster",
    "StreamSession",
    "bucket_size",
    "chain_fold",
]
