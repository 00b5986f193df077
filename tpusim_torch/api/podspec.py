"""SimulationPod spec parsing and expansion.

Reference: cmd/app/options/options.go:73-99 — decode a YAML/JSON list of
SimulationPod{name,pod,num}, expand each entry ``num`` times with a fresh UUID
used as both name and UID, labels replaced by {"SimulationName": entry name},
and the namespace forced to the CLI namespace.

PyYAML is imported only when a podspec is not JSON, so the package imports
and runs on machines without it.
"""

from __future__ import annotations

import json
import uuid
from typing import List

from tpusim_torch.api.types import DEFAULT_NAMESPACE, Pod, SimulationPod


def load_simulation_pods(path: str) -> List[SimulationPod]:
    with open(path) as f:
        text = f.read()
    return parse_simulation_pods(text)


def parse_simulation_pods(text: str) -> List[SimulationPod]:
    """Accepts YAML or JSON (YAMLOrJSONDecoder parity)."""
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        data = yaml.safe_load(text)
    if data is None:
        return []
    if not isinstance(data, list):
        raise ValueError("podspec must be a list of {name, pod, num} entries")
    return [SimulationPod.from_obj(o) for o in data]


def expand_simulation_pods(
    sim_pods: List[SimulationPod],
    namespace: str = DEFAULT_NAMESPACE,
    deterministic_ids: bool = False,
) -> List[Pod]:
    """Expand each SimulationPod ``num`` times (options.go:88-97).

    ``deterministic_ids`` swaps the UUIDs for stable "<name>-<i>" identifiers so
    tests and parity harnesses get reproducible pod names.
    """
    pods: List[Pod] = []
    for sp in sim_pods:
        for i in range(sp.num):
            pod = sp.pod.copy()
            uid = f"{sp.name}-{i}" if deterministic_ids else str(uuid.uuid4())
            pod.metadata.uid = uid
            pod.metadata.name = uid
            pod.metadata.labels = {"SimulationName": sp.name}
            pod.metadata.namespace = namespace
            pods.append(pod)
    return pods
