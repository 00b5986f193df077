"""The streaming twin: the compiled cluster resident on the device across
scheduling cycles, O(delta) commits of each cycle's watch events, classified
restages where a commit cannot express them, pipelined cycles and live
what-if overlays (runtime.StreamSession), driven by seeded churn
(loadgen.ChurnLoadGen); its durability: the WAL, checkpoints and crash
recovery (persist); the WAL shipped to a hot standby with leader failover
(replicate); and many tenants' twins under one device byte budget
(tenancy)."""

from tpusim_torch.stream.loadgen import ChurnLoadGen
from tpusim_torch.stream.persist import (
    CRASH_POINTS,
    PersistError,
    RecoveryReport,
    StreamPersistence,
    chain_fold,
    read_wal,
    recover_stream_session,
    tail_wal,
)
from tpusim_torch.stream.replicate import (
    FailoverController,
    FollowerTwin,
    PromotionRefused,
    PromotionReport,
    ReplicationError,
    WalShipper,
)
from tpusim_torch.stream.runtime import (
    MIN_BUCKET,
    DeviceResidentCluster,
    StreamSession,
    bucket_size,
)
from tpusim_torch.stream.tenancy import ResidencyBudget, TenantTwin

__all__ = [
    "CRASH_POINTS",
    "MIN_BUCKET",
    "ChurnLoadGen",
    "DeviceResidentCluster",
    "FailoverController",
    "FollowerTwin",
    "PersistError",
    "PromotionRefused",
    "PromotionReport",
    "RecoveryReport",
    "ReplicationError",
    "ResidencyBudget",
    "StreamPersistence",
    "StreamSession",
    "TenantTwin",
    "WalShipper",
    "bucket_size",
    "chain_fold",
    "read_wal",
    "recover_stream_session",
    "tail_wal",
]
