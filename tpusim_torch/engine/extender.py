"""Scheduler extender: out-of-process Filter/Prioritize/Bind hooks.

Reference: core/extender.go:40-293 (HTTPExtender) + api/types.go:164-260
(ExtenderConfig, ExtenderArgs, ExtenderFilterResult, ExtenderBindingArgs).

The wire protocol is kept byte-compatible with the reference — POST
`{url_prefix}/{verb}` with an ExtenderArgs JSON body ({"pod": ..., "nodes":
{"items": [...]}} or {"nodeNames": [...]} when node_cache_capable) — so real
kube-scheduler extender webhooks work unchanged. Two transports:

  * http (default): urllib POST with the configured timeout
    (DefaultExtenderTimeout 5s, extender.go:37-38).
  * in-process: any callable `(verb, args_dict) -> result_dict` — the natural
    seam for tests and for co-located Python extenders (no socket needed; the
    reference's simulator configures no extenders at all, simulator.go:375).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from tpusim_torch.api.types import Node, Pod
from tpusim_torch.engine.policy import ExtenderConfig
from tpusim_torch.engine.priorities import HostPriority

DEFAULT_EXTENDER_TIMEOUT = 5.0  # seconds (extender.go:37-38)


class ExtenderError(Exception):
    pass


def http_transport(url_prefix: str, timeout: float) -> Callable[[str, dict], dict]:
    """POST JSON to {url_prefix}/{verb} (extender.go send():233-263)."""

    def send(verb: str, args: dict) -> dict:
        url = url_prefix.rstrip("/") + "/" + verb
        req = urllib.request.Request(
            url, data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            if resp.status != 200:
                raise ExtenderError(
                    f"Failed {verb} with extender at URL {url_prefix}, "
                    f"code {resp.status}")
            return json.load(resp)

    return send


class HTTPExtender:
    """algorithm.SchedulerExtender implementation (core/extender.go:41-293)."""

    def __init__(self, config: ExtenderConfig,
                 transport: Optional[Callable[[str, dict], dict]] = None):
        self.extender_url = config.url_prefix
        self.filter_verb = config.filter_verb
        self.prioritize_verb = config.prioritize_verb
        self.bind_verb = config.bind_verb
        self.weight = config.weight
        self.node_cache_capable = config.node_cache_capable
        self.managed_resources = {r.name for r in config.managed_resources}
        timeout = config.http_timeout or DEFAULT_EXTENDER_TIMEOUT
        self._send = transport or http_transport(config.url_prefix, timeout)

    # --- args encoding (api/types.go ExtenderArgs:207-218) ---

    def _encode_args(self, pod: Pod, nodes: List[Node]) -> dict:
        if self.node_cache_capable:
            return {"pod": pod.to_obj(), "nodes": None,
                    "nodeNames": [n.name for n in nodes]}
        return {"pod": pod.to_obj(),
                "nodes": {"items": [n.to_obj() for n in nodes]},
                "nodeNames": None}

    # --- Filter (extender.go:105-163) ---

    def filter(self, pod: Pod, nodes: List[Node], node_info_map: dict
               ) -> Tuple[List[Node], Dict[str, str]]:
        """Returns (filtered subset, failed node → message). Raises on
        transport error or a result carrying Error — filter failures fail the
        pod's scheduling (generic_scheduler.go:360-363)."""
        if not self.filter_verb:
            return nodes, {}
        result = self._send(self.filter_verb, self._encode_args(pod, nodes))
        if result.get("error"):
            raise ExtenderError(result["error"])
        if self.node_cache_capable and result.get("nodeNames") is not None:
            node_result = [node_info_map[name].node
                           for name in result["nodeNames"]]
        elif result.get("nodes") is not None:
            by_name = {n.name: n for n in nodes}
            node_result = [by_name[item["metadata"]["name"]]
                           for item in result["nodes"].get("items", [])]
        else:
            node_result = []
        return node_result, dict(result.get("failedNodes") or {})

    # --- Prioritize (extender.go:165-209) ---

    def prioritize(self, pod: Pod, nodes: List[Node]
                   ) -> Tuple[List[HostPriority], int]:
        if not self.prioritize_verb:
            return [HostPriority(n.name, 0) for n in nodes], 0
        result = self._send(self.prioritize_verb, self._encode_args(pod, nodes))
        return [HostPriority(hp["host"], int(hp["score"])) for hp in result], \
            self.weight

    # --- Bind (extender.go:211-231) ---

    def bind(self, pod: Pod, node_name: str) -> None:
        if not self.is_binder():
            raise ExtenderError("Unexpected empty bindVerb in extender")
        args = {"podName": pod.name, "podNamespace": pod.namespace,
                "podUID": pod.metadata.uid, "node": node_name}
        result = self._send(self.bind_verb, args)
        if result and result.get("error"):
            raise ExtenderError(result["error"])

    def is_binder(self) -> bool:
        return bool(self.bind_verb)

    # --- IsInterested (extender.go:265-293) ---

    def is_interested(self, pod: Pod) -> bool:
        if not self.managed_resources:
            return True
        for container in list(pod.spec.containers) + list(pod.spec.init_containers):
            for name in list(container.requests) + list(container.limits):
                if name in self.managed_resources:
                    return True
        return False


def new_http_extender(config: ExtenderConfig,
                      transport: Optional[Callable] = None) -> HTTPExtender:
    """core/extender.go NewHTTPExtender:76-104."""
    return HTTPExtender(config, transport=transport)
