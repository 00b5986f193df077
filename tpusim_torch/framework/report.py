"""Report model + printers — the tool's real output contract.

Reference: pkg/framework/report.go. Three buckets (success / failed /
scheduled) each with per-pod requirements and a reason histogram, printed as
header + ASCII tables (tablewriter-style).
"""

from __future__ import annotations

from dataclasses import dataclass, field
import datetime
import io
from typing import Dict, List, Optional

from tpusim_torch.api.quantity import Quantity
from tpusim_torch.api.types import RESOURCE_NVIDIA_GPU, Pod, is_scalar_resource_name


@dataclass
class Status:
    """Reference: report.go:240-245 (+ preempted_pods, an extension populated
    only when the PodPriority gate is on)."""

    successful_pods: List[Pod] = field(default_factory=list)
    failed_pods: List[Pod] = field(default_factory=list)
    scheduled_pods: List[Pod] = field(default_factory=list)
    stop_reason: str = ""
    preempted_pods: List[Pod] = field(default_factory=list)


@dataclass
class Resources:
    """Reference: report.go Resources{PrimaryResources, ScalarResources}."""

    cpu: Quantity = field(default_factory=lambda: Quantity(0))
    memory: Quantity = field(default_factory=lambda: Quantity(0))
    nvidia_gpu: Quantity = field(default_factory=lambda: Quantity(0))
    scalar: Dict[str, int] = field(default_factory=dict)


def get_resource_request(pod: Pod) -> Resources:
    """Reference: report.go:96-129 — containers only (no init-container max)."""
    result = Resources()
    for container in pod.spec.containers:
        for name, q in container.requests.items():
            if name == "cpu":
                result.cpu = result.cpu + q
            elif name == "memory":
                result.memory = result.memory + q
            elif name == RESOURCE_NVIDIA_GPU:
                result.nvidia_gpu = result.nvidia_gpu + q
            elif is_scalar_resource_name(name):
                result.scalar[name] = result.scalar.get(name, 0) + q.value()
    return result


@dataclass
class Requirements:
    pod_name: str
    resources: Resources
    node_selectors: Optional[dict]


@dataclass
class PodReviewResult:
    pod_uid: str
    pod_name: str
    host: str
    reason: str
    resources: Resources


@dataclass
class ClusterCapacityReviewSpec:
    pods: List[Pod]
    pod_requirements: List[Requirements]


@dataclass
class ClusterCapacityReviewStatus:
    creation_timestamp: datetime.datetime
    pods: List[PodReviewResult]
    reason_summary: Dict[str, List[PodReviewResult]]


@dataclass
class ClusterCapacityReview:
    spec: ClusterCapacityReviewSpec
    status: ClusterCapacityReviewStatus


@dataclass
class ScheduleFailReason:
    fail_type: str
    fail_message: str


@dataclass
class GeneralReview:
    review: Dict[str, ClusterCapacityReview]
    fail_reason: ScheduleFailReason


def _review_of(pods: List[Pod]) -> ClusterCapacityReview:
    requirements = [Requirements(pod_name=p.name, resources=get_resource_request(p),
                                 node_selectors=p.spec.node_selector) for p in pods]
    results: List[PodReviewResult] = []
    reason_summary: Dict[str, List[PodReviewResult]] = {}
    for p in pods:
        prr = PodReviewResult(pod_uid=p.metadata.uid, pod_name=p.name,
                              host=p.spec.node_name, reason=p.status.reason,
                              resources=get_resource_request(p))
        reason_summary.setdefault(prr.reason, []).append(prr)
        results.append(prr)
    return ClusterCapacityReview(
        spec=ClusterCapacityReviewSpec(pods=pods, pod_requirements=requirements),
        status=ClusterCapacityReviewStatus(
            creation_timestamp=datetime.datetime.now(), pods=results,
            reason_summary=reason_summary))


def get_report(status: Status) -> GeneralReview:
    """Reference: report.go:168-180 (GetReport)."""
    return GeneralReview(
        review={
            "failed": _review_of(status.failed_pods),
            "success": _review_of(status.successful_pods),
            "scheduled": _review_of(status.scheduled_pods),
        },
        fail_reason=ScheduleFailReason(fail_type="Stopped",
                                       fail_message=status.stop_reason))


# ---------------------------------------------------------------------------
# printing (report.go:182-237; tablewriter-style ASCII tables)
# ---------------------------------------------------------------------------


def _render_table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep,
           "|" + "|".join(f" {h.upper():<{w}} " for h, w in zip(headers, widths)) + "|",
           sep]
    for row in rows:
        out.append("|" + "|".join(f" {c:<{w}} " for c, w in zip(row, widths)) + "|")
    out.append(sep)
    return "\n".join(out)


def _print_header(title: str, out) -> None:
    print(f"================================= {title} =================================",
          file=out)


def _distribute_pods_print(review: ClusterCapacityReview, out) -> None:
    rows = [[f"CPU: {s.resources.cpu}, Memory: {s.resources.memory}", s.host]
            for s in review.status.pods]
    print(_render_table(["Requirements", "Host"], rows), file=out)


def _status_print(status: ClusterCapacityReviewStatus, out) -> None:
    print("Pods summary:", file=out)
    for reason, pods in status.reason_summary.items():
        print(f"\t- {reason}: {len(pods)}", file=out)


def spec_print(spec: ClusterCapacityReviewSpec, out=None) -> None:
    """Reference: report.go:182-204 — per-pod requirement listing."""
    import sys

    out = out or sys.stdout
    for req in spec.pod_requirements:
        print(f"{req.pod_name} pod requirements:", file=out)
        print(f"\t- CPU: {req.resources.cpu}", file=out)
        print(f"\t- Memory: {req.resources.memory}", file=out)
        if not req.resources.nvidia_gpu.is_zero():
            print(f"\t- NvidiaGPU: {req.resources.nvidia_gpu}", file=out)
        if req.resources.scalar:
            print(f"\t- ScalarResources: {req.resources.scalar}", file=out)
        if req.node_selectors:
            selector = ",".join(f"{k}={v}" for k, v in sorted(req.node_selectors.items()))
            print(f"\t- NodeSelector: {selector}", file=out)
        print(file=out)


def cluster_capacity_review_print(review: GeneralReview, out=None) -> None:
    """Reference: report.go:234-237 — successful then failed pods."""
    import sys

    out = out or sys.stdout
    _print_header("Successful Pods", out)
    _distribute_pods_print(review.review["success"], out)
    _print_header("Failed Pods", out)
    _status_print(review.review["failed"].status, out)
    _distribute_pods_print(review.review["failed"], out)


def review_to_string(review: GeneralReview) -> str:
    buf = io.StringIO()
    cluster_capacity_review_print(review, out=buf)
    return buf.getvalue()
