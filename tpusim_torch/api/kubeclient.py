"""Live-cluster snapshotter: a minimal kube-apiserver REST client.

Reference: cmd/app/server.go:71-118 — the ONLY real network I/O in the whole
reference program is the initial checkpoint: List Running pods (FieldSelector
"status.phase=Running", namespace-scoped when --namespace is set) plus all
nodes, via a client built from kubeconfig (clientcmd.BuildConfigFromFlags) or,
when the CC_INCLUSTER env var is present, the in-cluster service-account
config (server.go:62-69). Everything after the snapshot is in-process.

Implemented on the stdlib (urllib + ssl), so the build carries no
client-go analog dependency; kubeconfig parsing covers the fields the
reference path exercises: current-context resolution, cluster server +
certificate-authority(-data) + insecure-skip-tls-verify, and user token /
tokenFile / client-certificate(-data) / client-key(-data) / basic auth.

A kubeconfig is read as JSON first (kubectl accepts JSON kubeconfigs too),
and only text that is not JSON goes to PyYAML, imported then: a machine
without PyYAML reads a JSON kubeconfig and refuses a YAML one with a
KubeConfigError that says so, and never reads an unparsable file as empty.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import tempfile
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from tpusim_torch.api.snapshot import ClusterSnapshot
from tpusim_torch.api.types import Node, Pod

SERVICE_ACCOUNT_ROOT = "/var/run/secrets/kubernetes.io/serviceaccount"
RUNNING_FIELD_SELECTOR = "status.phase=Running"


class KubeConfigError(ValueError):
    pass


@dataclass
class KubeClientConfig:
    server: str
    ca_file: str = ""
    insecure_skip_tls_verify: bool = False
    token: str = ""
    username: str = ""
    password: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    _temp_files: list = field(default_factory=list, repr=False)

    def cleanup(self) -> None:
        """Unlink materialized *-data temp files (may hold client TLS keys);
        safe to call repeatedly. Call after the client's TLS context is built
        — ssl reads the files eagerly."""
        for path in self._temp_files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._temp_files.clear()


def _materialize(data_b64: str, suffix: str, cfg: KubeClientConfig) -> str:
    """Write a base64 *-data kubeconfig field to a temp file (ssl wants paths)."""
    f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    f.write(base64.b64decode(data_b64))
    f.close()
    cfg._temp_files.append(f.name)
    return f.name


def _by_name(items, name: str, kind: str) -> dict:
    for item in items or []:
        if item.get("name") == name:
            return item.get(kind) or {}
    raise KubeConfigError(f"kubeconfig: no {kind} named {name!r}")


def _parse_kubeconfig(path: str):
    """JSON first, then YAML through a lazily imported PyYAML."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as exc:
        raise KubeConfigError(
            "kubeconfig: not JSON, and PyYAML is not installed to read it "
            "as YAML (write the kubeconfig as JSON)") from exc
    try:
        with open(path) as f:  # a stream, so errors name the file
            return yaml.safe_load(f)
    except yaml.YAMLError as exc:
        raise KubeConfigError(f"kubeconfig: invalid YAML: {exc}") from exc


def load_kubeconfig(path: str, context: str = "") -> KubeClientConfig:
    """clientcmd.BuildConfigFromFlags("", path) essentials: resolve
    current-context (or `context`) to a (cluster, user) pair."""
    doc = _parse_kubeconfig(path)
    if not isinstance(doc, dict):
        raise KubeConfigError("kubeconfig: not a mapping")
    ctx_name = context or doc.get("current-context") or ""
    if not ctx_name:
        raise KubeConfigError("kubeconfig: no current-context")
    ctx = _by_name(doc.get("contexts"), ctx_name, "context")
    cluster = _by_name(doc.get("clusters"), ctx.get("cluster", ""), "cluster")
    user = _by_name(doc.get("users"), ctx.get("user", ""), "user") \
        if ctx.get("user") else {}

    server = cluster.get("server") or ""
    if not server:
        raise KubeConfigError("kubeconfig: cluster has no server")
    cfg = KubeClientConfig(
        server=server.rstrip("/"),
        insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify")))
    try:
        if cluster.get("certificate-authority"):
            cfg.ca_file = cluster["certificate-authority"]
        elif cluster.get("certificate-authority-data"):
            cfg.ca_file = _materialize(cluster["certificate-authority-data"],
                                       ".crt", cfg)
        token = user.get("token") or ""
        if not token and user.get("tokenFile"):
            with open(user["tokenFile"]) as f:
                token = f.read().strip()
        cfg.token = token
        cfg.username = user.get("username") or ""
        cfg.password = user.get("password") or ""
        if user.get("client-certificate"):
            cfg.client_cert_file = user["client-certificate"]
        elif user.get("client-certificate-data"):
            cfg.client_cert_file = _materialize(user["client-certificate-data"],
                                                ".crt", cfg)
        if user.get("client-key"):
            cfg.client_key_file = user["client-key"]
        elif user.get("client-key-data"):
            cfg.client_key_file = _materialize(user["client-key-data"], ".key",
                                               cfg)
    except Exception:
        # materialized *-data temp files can hold client TLS keys; don't
        # leave them behind when the rest of the config fails to parse
        cfg.cleanup()
        raise
    return cfg


def in_cluster_config(root: str = SERVICE_ACCOUNT_ROOT,
                      environ=os.environ) -> KubeClientConfig:
    """rest.InClusterConfig: server from KUBERNETES_SERVICE_HOST/PORT, bearer
    token + CA from the mounted service account."""
    host = environ.get("KUBERNETES_SERVICE_HOST", "")
    port = environ.get("KUBERNETES_SERVICE_PORT", "")
    if not host or not port:
        raise KubeConfigError(
            "in-cluster config: KUBERNETES_SERVICE_HOST/PORT not set")
    token_path = os.path.join(root, "token")
    ca_path = os.path.join(root, "ca.crt")
    with open(token_path) as f:
        token = f.read().strip()
    # net.JoinHostPort semantics: bracket IPv6 hosts
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"
    return KubeClientConfig(server=f"https://{host}:{port}", token=token,
                            ca_file=ca_path if os.path.exists(ca_path) else "")


class KubeClient:
    def __init__(self, config: KubeClientConfig, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        self._ssl_context: Optional[ssl.SSLContext] = None
        if config.server.startswith("https"):
            if config.insecure_skip_tls_verify:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                ctx = ssl.create_default_context(
                    cafile=config.ca_file or None)
            if config.client_cert_file:
                ctx.load_cert_chain(config.client_cert_file,
                                    config.client_key_file or None)
            self._ssl_context = ctx

    def _get(self, path: str, query: Optional[dict] = None) -> dict:
        url = self.config.server + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(url)
        req.add_header("Accept", "application/json")
        if self.config.token:
            req.add_header("Authorization", f"Bearer {self.config.token}")
        elif self.config.username:
            basic = base64.b64encode(
                f"{self.config.username}:{self.config.password}".encode()
            ).decode()
            req.add_header("Authorization", f"Basic {basic}")
        with urllib.request.urlopen(req, timeout=self.timeout,
                                    context=self._ssl_context) as resp:
            return json.load(resp)

    def list_running_pods(self, namespace: str = "") -> List[Pod]:
        """Pods(namespace).List(FieldSelector: status.phase=Running)
        (server.go:105); empty namespace = all namespaces."""
        path = (f"/api/v1/namespaces/{urllib.parse.quote(namespace)}/pods"
                if namespace else "/api/v1/pods")
        body = self._get(path, {"fieldSelector": RUNNING_FIELD_SELECTOR})
        return [Pod.from_obj(item) for item in body.get("items") or []]

    def list_nodes(self) -> List[Node]:
        """Nodes().List() (server.go:111)."""
        body = self._get("/api/v1/nodes")
        return [Node.from_obj(item) for item in body.get("items") or []]

    def get_configmap(self, namespace: str, name: str) -> dict:
        """ConfigMaps(namespace).Get(name) — the live scheduler-policy source
        (simulator.go:402-406). Returns the raw ConfigMap object."""
        path = (f"/api/v1/namespaces/{urllib.parse.quote(namespace)}"
                f"/configmaps/{urllib.parse.quote(name)}")
        return self._get(path)


def get_checkpoints(client: KubeClient,
                    namespace: str = "") -> Tuple[List[Pod], List[Node]]:
    """The reference's getCheckpoints (server.go:104-118)."""
    return client.list_running_pods(namespace), client.list_nodes()


def snapshot_from_cluster(kubeconfig: str = "", namespace: str = "",
                          context: str = "") -> ClusterSnapshot:
    """Build a simulation snapshot from a live cluster: kubeconfig when given,
    else the in-cluster service-account config (the CC_INCLUSTER path,
    server.go:62-69)."""
    config = (load_kubeconfig(kubeconfig, context) if kubeconfig
              else in_cluster_config())
    try:
        client = KubeClient(config)
    finally:
        config.cleanup()
    pods, nodes = get_checkpoints(client, namespace)
    return ClusterSnapshot(nodes=nodes, pods=pods)
