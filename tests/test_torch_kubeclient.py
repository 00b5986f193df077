"""The port's live-cluster snapshotter (api/kubeclient.py) and the CLI's
--kubeconfig and --scheduler-policy-configmap against the JAX package's,
on the CPU, with a local fake apiserver (127.0.0.1, a port the OS picks).

The cases of tests/test_kubeclient.py run on both packages: checkpoints
(Running pods through the status.phase field selector, bearer auth on the
wire), namespaced lists, base64 *-data fields with basic auth, the cleanup
of materialized key files, the in-cluster config, the kubeconfig errors,
the live ConfigMap with its three errors, and the CLI's conflict error.
The CLI's report against chip_smoke.live_cluster (at a small shape) must be
byte-equal to the JAX CLI's, timing aside. With PyYAML hidden
(sys.modules["yaml"] = None) a JSON kubeconfig still loads and a YAML one
raises KubeConfigError. Tolerance: exact.
"""

import base64
import contextlib
import io
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import tpusim.api.kubeclient as jax_kc
import tpusim.api.snapshot as jax_api
from tpusim.cli import main as jax_main

import chip_smoke
import tpusim_torch.api.kubeclient as port_kc
import tpusim_torch.api.snapshot as port_api
from tpusim_torch.cli import main as port_main

PACKAGES = {"jax": (jax_kc, jax_api), "port": (port_kc, port_api)}
POLICY_JSON = json.dumps({
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [{"name": "PodFitsResources"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 1}],
})
PODSPEC = json.dumps([{"name": "A", "num": 2, "pod": {"spec": {
    "containers": [{"resources": {"requests": {"cpu": "1"}}}]}}}])


class FakeApiServer:
    """/api/v1 lists, ConfigMaps and request capture (path, query,
    Authorization), as tests/test_kubeclient.py's."""

    def __init__(self, pods, nodes, configmaps=None):
        self.requests = []
        configmaps = configmaps or {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                parsed = urllib.parse.urlparse(self.path)
                query = dict(urllib.parse.parse_qsl(parsed.query))
                outer.requests.append((parsed.path, query,
                                       self.headers.get("Authorization")))
                parts = parsed.path.split("/")
                running = query.get("fieldSelector") == "status.phase=Running"
                if len(parts) == 7 and parts[5] == "configmaps":
                    body = configmaps.get((parts[4], parts[6]))
                elif parsed.path == "/api/v1/nodes":
                    body = {"items": [n.to_obj() for n in nodes]}
                elif parsed.path == "/api/v1/pods" or (
                        len(parts) == 6 and parts[5] == "pods"):
                    ns = parts[4] if len(parts) == 6 else None
                    body = {"items": [
                        p.to_obj() for p in pods
                        if (ns is None or p.namespace == ns)
                        and (not running or p.status.phase == "Running")]}
                else:
                    body = None
                if body is None:
                    self.send_error(404)
                    return
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def configmap(name, data):
    return {"kind": "ConfigMap", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": "kube-system"},
            "data": data}


def cluster(api):
    pods = [api.make_pod("run-1", milli_cpu=500, node_name="n0",
                         phase="Running"),
            api.make_pod("run-2", milli_cpu=250, node_name="n1",
                         phase="Running", namespace="prod"),
            api.make_pod("pending", milli_cpu=100)]
    nodes = [api.make_node("n0"), api.make_node("n1")]
    cms = {("kube-system", "sched-policy"): configmap(
               "sched-policy", {"policy.cfg": POLICY_JSON}),
           ("kube-system", "no-key"): configmap("no-key", {"other": "x"})}
    return pods, nodes, cms


@pytest.fixture(params=sorted(PACKAGES))
def served(request):
    """(package name, kubeclient module, api module, server)."""
    kc, api = PACKAGES[request.param]
    pods, nodes, cms = cluster(api)
    server = FakeApiServer(pods, nodes, cms)
    yield request.param, kc, api, server
    server.stop()


def kubeconfig(tmp_path, server_url, user=None, cluster_extra=None,
               name="kubeconfig.json"):
    doc = {"current-context": "sim",
           "contexts": [{"name": "sim",
                         "context": {"cluster": "c1", "user": "u1"}}],
           "clusters": [{"name": "c1", "cluster": dict(
               {"server": server_url}, **(cluster_extra or {}))}],
           "users": [{"name": "u1", "user": user or {"token": "secret"}}]}
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def test_get_checkpoints_semantics(served, tmp_path):
    _, kc, _, server = served
    cfg = kc.load_kubeconfig(kubeconfig(tmp_path, server.url))
    pods, nodes = kc.get_checkpoints(kc.KubeClient(cfg))
    assert sorted(p.name for p in pods) == ["run-1", "run-2"]
    assert sorted(n.name for n in nodes) == ["n0", "n1"]
    assert server.requests == [
        ("/api/v1/pods", {"fieldSelector": "status.phase=Running"},
         "Bearer secret"),
        ("/api/v1/nodes", {}, "Bearer secret")]


def test_namespaced_pod_list(served, tmp_path):
    _, kc, _, server = served
    cfg = kc.load_kubeconfig(kubeconfig(tmp_path, server.url))
    assert [p.name for p in kc.KubeClient(cfg).list_running_pods("prod")] \
        == ["run-2"]
    assert server.requests[0][0] == "/api/v1/namespaces/prod/pods"


def test_snapshot_from_cluster_matches_jax(tmp_path):
    snaps = {}
    for name, (kc, api) in PACKAGES.items():
        pods, nodes, cms = cluster(api)
        server = FakeApiServer(pods, nodes, cms)
        try:
            snaps[name] = kc.snapshot_from_cluster(
                kubeconfig=kubeconfig(tmp_path, server.url))
        finally:
            server.stop()
    assert json.dumps(snaps["port"].to_obj(), sort_keys=True) == \
        json.dumps(snaps["jax"].to_obj(), sort_keys=True)
    assert (len(snaps["port"].nodes), len(snaps["port"].pods)) == (2, 2)


def test_base64_data_and_basic_auth(served, tmp_path):
    _, kc, _, server = served
    cfg = kc.load_kubeconfig(kubeconfig(
        tmp_path, server.url, user={"username": "alice", "password": "pw"},
        cluster_extra={"certificate-authority-data":
                       base64.b64encode(b"fake-ca").decode()}))
    try:
        assert open(cfg.ca_file, "rb").read() == b"fake-ca"
        kc.KubeClient(cfg).list_nodes()
    finally:
        cfg.cleanup()
    assert server.requests[0][2] == \
        "Basic " + base64.b64encode(b"alice:pw").decode()


def test_materialized_key_files_cleaned_up(served, tmp_path):
    _, kc, _, server = served
    cfg = kc.load_kubeconfig(kubeconfig(
        tmp_path, server.url,
        cluster_extra={"certificate-authority-data":
                       base64.b64encode(b"ca").decode()}))
    files = list(cfg._temp_files)
    assert files and all(os.path.exists(p) for p in files)
    cfg.cleanup()
    cfg.cleanup()  # safe to repeat
    assert not cfg._temp_files and not any(os.path.exists(p) for p in files)


def test_kubeconfig_errors_match_jax(tmp_path):
    docs = {"no_context": json.dumps({"clusters": []}),
            "malformed": "{unclosed: [",
            "no_server": json.dumps({
                "current-context": "sim",
                "contexts": [{"name": "sim", "context": {"cluster": "c"}}],
                "clusters": [{"name": "c", "cluster": {}}]}),
            "no_user_named": json.dumps({
                "current-context": "sim",
                "contexts": [{"name": "sim",
                              "context": {"cluster": "c", "user": "u"}}],
                "clusters": [{"name": "c",
                              "cluster": {"server": "http://x"}}]}),
            "not_a_mapping": "[1, 2]"}
    for name, text in docs.items():
        path = tmp_path / name
        path.write_text(text)
        errors = []
        for kc, _ in PACKAGES.values():
            with pytest.raises(kc.KubeConfigError) as exc:
                kc.load_kubeconfig(str(path))
            errors.append(str(exc.value))
        assert errors[0] == errors[1], name


def test_in_cluster_config(tmp_path):
    root = tmp_path / "sa"
    root.mkdir()
    (root / "token").write_text("sa-token\n")
    (root / "ca.crt").write_text("ca")
    env = {"KUBERNETES_SERVICE_HOST": "fd00::1",
           "KUBERNETES_SERVICE_PORT": "443"}
    configs = [kc.in_cluster_config(root=str(root), environ=env)
               for kc, _ in PACKAGES.values()]
    assert [(c.server, c.token, c.ca_file) for c in configs] == \
        [("https://[fd00::1]:443", "sa-token", str(root / "ca.crt"))] * 2
    with pytest.raises(port_kc.KubeConfigError):
        port_kc.in_cluster_config(root=str(root), environ={})


def test_get_configmap(served, tmp_path):
    _, kc, _, server = served
    cfg = kc.load_kubeconfig(kubeconfig(tmp_path, server.url))
    obj = kc.KubeClient(cfg).get_configmap("kube-system", "sched-policy")
    assert obj["data"]["policy.cfg"] == POLICY_JSON


def run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, chip_smoke.report_digest(out.getvalue()), err.getvalue()


CLI_CASES = {
    "live_policy": ["--scheduler-policy-configmap", "sched-policy"],
    "provider": [],
    "missing_key": ["--scheduler-policy-configmap", "no-key"],
    "absent_configmap": ["--scheduler-policy-configmap", "absent"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_live_cluster_matches_jax(case, tmp_path):
    spec = tmp_path / "pods.json"
    spec.write_text(PODSPEC)
    results = {}
    for name, (kc, api) in PACKAGES.items():
        pods, nodes, cms = cluster(api)
        server = FakeApiServer(pods, nodes, cms)
        try:
            argv = ["--kubeconfig", kubeconfig(tmp_path, server.url),
                    "--podspec", str(spec), *CLI_CASES[case]]
            results[name] = run_cli(*(
                (jax_main, argv + ["--backend", "reference"]) if name == "jax"
                else (port_main, argv + ["--device", "cpu"])))
        finally:
            server.stop()
    assert results["port"] == results["jax"]
    rc, _, err = results["port"]
    if case == "missing_key":
        assert rc == 2 and err.strip() == (
            'error: invalid scheduler policy: missing policy config map '
            'value at key "policy.cfg"')
    elif case == "absent_configmap":
        assert rc == 2 and err.startswith(
            "error: couldn't get policy config map kube-system/absent: ")
    else:
        assert rc == 0


@pytest.mark.parametrize("argv,needle", [
    (["--kubeconfig", "/nonexistent-kc", "--snapshot", "/nonexistent"],
     "conflicts"),
    (["--synthetic-nodes", "2", "--scheduler-policy-configmap", "p"],
     "needs a cluster connection")])
def test_cli_refusals_match_jax(argv, needle, tmp_path):
    spec = tmp_path / "pods.json"
    spec.write_text(PODSPEC)
    argv = argv + ["--podspec", str(spec)]
    want = run_cli(jax_main, argv + ["--backend", "reference"])
    got = run_cli(port_main, argv + ["--device", "cpu"])
    assert got == want
    assert got[0] == 2 and needle in got[2]


def test_cli_report_on_the_live_cluster_matches_jax(tmp_path):
    """chip_smoke phase 30b's flow at a small shape: the interpod workload's
    live cluster with decoys, the ConfigMap policy and the default
    provider."""
    reports = {}
    for name, (_, api) in PACKAGES.items():
        nodes, served_pods, _ = chip_smoke.live_cluster(api, 2_000, 60)
        server = chip_smoke.FakeApiServer(
            nodes, served_pods, chip_smoke.live_configmaps(),
            chip_smoke.LIVE_TOKEN)
        try:
            kc, spec = chip_smoke.write_live_files(str(tmp_path), server.url)
            for extra in (["--scheduler-policy-configmap",
                           chip_smoke.LIVE_POLICY[1]], []):
                argv = ["--kubeconfig", kc, "--podspec", spec, *extra]
                reports.setdefault(name, []).append(run_cli(*(
                    (jax_main, argv + ["--backend", "jax"]) if name == "jax"
                    else (port_main, argv + ["--device", "cpu"]))))
        finally:
            server.stop()
    assert reports["port"] == reports["jax"]
    assert all(rc == 0 for rc, _, _ in reports["port"])


# --- PyYAML absent --------------------------------------------------------

def test_kubeconfig_without_pyyaml(monkeypatch, tmp_path):
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    path = kubeconfig(tmp_path, "http://127.0.0.1:1")
    assert port_kc.load_kubeconfig(path).token == "secret"
    yaml_path = tmp_path / "kubeconfig.yaml"
    yaml_path.write_text("current-context: sim\ncontexts: []\n")
    with pytest.raises(port_kc.KubeConfigError, match="PyYAML"):
        port_kc.load_kubeconfig(str(yaml_path))
    empty = tmp_path / "empty"
    empty.write_text("")
    with pytest.raises(port_kc.KubeConfigError):
        port_kc.load_kubeconfig(str(empty))


def test_yaml_kubeconfig_with_pyyaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "kc.yaml"
    path.write_text(yaml.safe_dump({
        "current-context": "sim",
        "contexts": [{"name": "sim",
                      "context": {"cluster": "c1", "user": "u1"}}],
        "clusters": [{"name": "c1", "cluster": {"server": "http://h:1/"}}],
        "users": [{"name": "u1", "user": {"token": "t"}}]}))
    got, want = (kc.load_kubeconfig(str(path)) for kc in (port_kc, jax_kc))
    assert (got.server, got.token) == (want.server, want.token) == \
        ("http://h:1", "t")
