"""The port's chain-divergence audit (tpusim_torch/obs/audit.py and the
`audit` subcommand) against the JAX package's, on the CPU.

Every case of tests/test_audit.py's tier-1 set runs on the port, and each
report the port gives is held equal to the JAX package's report on the same
WAL pair. The one field that may differ is a wall time: the "ts" stamp of
each decision record of the forensic re-run. The journals the port writes
equal the JAX package's (tests/test_torch_persist.py), and the cross-package
case audits a pair written by each package with each package: all four
reports are equal, the directory names aside. Tolerance: exact.

The JAX file's slow sharded repro harness has no counterpart: the port's
twin is single-device (its checkpoints carry no shard layout).
"""

import copy
import json
import os
import shutil

import pytest

from tpusim.cli import main as jax_main
from tpusim.obs.audit import audit_wal_pair as jax_audit
from tpusim.simulator import run_stream_simulation as jax_stream

from tpusim_torch.cli import main as port_main
from tpusim_torch.obs.audit import (
    CycleDigest,
    audit_wal_pair,
    first_divergence,
    render_report,
)
from tpusim_torch.simulator import run_stream_simulation
from tpusim_torch.stream.persist import StreamPersistence

CFG = dict(num_nodes=8, cycles=6, arrivals=6, evict_fraction=0.25, seed=3)


def strip(report):
    """The report without its wall times (each decision record's ts)."""
    out = copy.deepcopy(report)
    for rec in out.get("replay", {}).get("decisions", []):
        rec.pop("ts", None)
    return out


def port_audit(a, b, **kw):
    return audit_wal_pair(a, b, device="cpu", **kw)


def audit_both(a, b, **kw):
    """The port's report, asserted equal to the JAX package's."""
    mine = port_audit(a, b, **kw)
    theirs = jax_audit(a, b, **kw)
    assert strip(mine) == strip(theirs)
    assert render_report(strip(mine)) == render_report(strip(theirs))
    return mine


@pytest.fixture(scope="module")
def wal_base(tmp_path_factory):
    """One journaled run of the port (the genesis checkpoint only, so any
    cycle can be replayed): perturbations copy it."""
    d = tmp_path_factory.mktemp("audit-base")
    out = run_stream_simulation(**CFG, checkpoint_dir=str(d),
                                checkpoint_every=0, device="cpu")
    assert out["fold_chain"]
    return str(d)


def _copy(wal_base, tmp_path, name="b"):
    dst = str(tmp_path / name)
    shutil.copytree(wal_base, dst)
    return dst


def _wal_lines(directory):
    with open(os.path.join(directory, StreamPersistence.WAL),
              encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _rewrite(directory, records):
    with open(os.path.join(directory, StreamPersistence.WAL), "w",
              encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")


def _flip_bind(directory, min_cycle=2):
    """Flip the first bind of the first cycle >= min_cycle with binds to
    another node (the recipe of tests/test_audit.py); returns (cycle,
    pod, node, flipped)."""
    records = _wal_lines(directory)
    nodes = sorted({n for r in records if r["k"] == "bind"
                    for _, n in r["b"]})
    target = next(r for r in records
                  if r["k"] == "bind" and r["c"] >= min_cycle and r["b"])
    pod_key, node = target["b"][0]
    flipped = next(n for n in nodes if n != node)
    target["b"][0] = [pod_key, flipped]
    _rewrite(directory, records)
    return target["c"], pod_key, node, flipped


def test_identical_pair_verdict(wal_base, tmp_path):
    copy_dir = _copy(wal_base, tmp_path)
    report = audit_both(wal_base, copy_dir)
    assert report["verdict"] == "identical"
    assert report["divergent_cycle"] is None
    assert "chains identical" in render_report(report)


def test_bind_flip_is_pinpointed_with_score_parts(wal_base, tmp_path):
    copy_dir = _copy(wal_base, tmp_path)
    cycle, pod_key, node, flipped = _flip_bind(copy_dir)

    report = audit_both(wal_base, copy_dir, explain_k=3)
    assert report["verdict"] == "diverged"
    assert report["divergent_cycle"] == cycle
    assert report["kind"] == "bind"
    [row] = report["bind_diff"]
    assert row == {"pod": pod_key, "a": node, "b": flipped}
    # the deterministic re-decision sides with the unperturbed journal
    assert report["replay_agrees_with"] == "a"
    rerun = report["replay"]
    assert sorted(dict(rerun["placements"]).items()) == \
        sorted(rerun["placements"])
    decided = {d["pod"]: d for d in rerun["decisions"]}
    assert decided[pod_key]["node"] == node
    # the explain lanes carried score parts by priority for the candidates
    top = decided[pod_key]["top_k"]
    assert top and all("score" in c and "node" in c for c in top)
    assert any(c.get("parts") for c in top)
    assert "violations" not in rerun
    text = render_report(report)
    assert f"FIRST DIVERGENT CYCLE: {cycle}" in text
    assert pod_key in text and "candidate" in text


def test_emit_hash_flip_classified(wal_base, tmp_path):
    copy_dir = _copy(wal_base, tmp_path)
    records = _wal_lines(copy_dir)
    target = next(r for r in records if r["k"] == "emit" and r["c"] >= 2)
    target["h"] = "f" * len(target["h"])
    _rewrite(copy_dir, records)
    report = audit_both(wal_base, copy_dir, replay=False)
    assert report["verdict"] == "diverged"
    assert report["divergent_cycle"] == target["c"]
    assert report["kind"] == "emit"
    assert report["bind_diff"] == []
    assert report["emit_hash"]["b"] != report["emit_hash"]["a"]


def test_truncated_journal_diverges_at_first_missing_cycle(wal_base,
                                                           tmp_path):
    copy_dir = _copy(wal_base, tmp_path)
    records = _wal_lines(copy_dir)
    last = max(r["c"] for r in records)
    _rewrite(copy_dir, [r for r in records if r["c"] < last])
    report = audit_both(wal_base, copy_dir, replay=False)
    assert report["verdict"] == "diverged"
    assert report["divergent_cycle"] == last
    assert report["kind"] == "missing_cycle"


def test_first_divergence_bisects_not_scans():
    """The bisection is chain-driven: digest tables that agree on a long
    prefix and differ once are pinpointed exactly."""
    a = {c: CycleDigest(cycle=c, binds=[("p", f"n{c}")]) for c in range(50)}
    b = {c: CycleDigest(cycle=c, binds=[("p", f"n{c}")]) for c in range(50)}
    b[37] = CycleDigest(cycle=37, binds=[("p", "elsewhere")])
    assert first_divergence(a, b) == 37
    assert first_divergence(a, dict(a)) is None
    from tpusim.obs.audit import CycleDigest as JaxDigest

    assert a[3].digest() == JaxDigest(cycle=3, binds=[("p", "n3")]).digest()


def test_checkpoint_past_divergence_skips_replay_gracefully(tmp_path):
    """A checkpoint cadence that already folded the divergent cycle into
    its snapshot cannot support a prefix replay: the audit says so."""
    a = tmp_path / "ck-a"
    b = tmp_path / "ck-b"
    run_stream_simulation(**CFG, checkpoint_dir=str(a), checkpoint_every=1,
                          device="cpu")
    shutil.copytree(str(a), str(b))
    records = _wal_lines(str(b))
    target = next(r for r in records
                  if r["k"] == "bind" and r["c"] == 1 and r["b"])
    target["b"][0] = [target["b"][0][0], "no-such-node"]
    _rewrite(str(b), records)
    report = audit_both(str(a), str(b))
    assert report["verdict"] == "diverged"
    assert report["divergent_cycle"] == 1
    assert "replay_skipped" in report
    assert "checkpoint_every=0" in report["replay_skipped"]
    assert "replay skipped" in render_report(report)


def test_audit_cli_end_to_end(wal_base, tmp_path, capsys):
    copy_dir = _copy(wal_base, tmp_path)
    assert port_main(["audit", wal_base, copy_dir, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "chains identical" in out
    assert jax_main(["audit", wal_base, copy_dir]) == 0
    assert capsys.readouterr().out == out

    cycle, _, _, _ = _flip_bind(copy_dir)
    artifact = str(tmp_path / "report.json")
    rc = port_main(["audit", wal_base, copy_dir, "--json", "--out",
                    artifact, "--device", "cpu"])
    assert rc == 1
    body = json.loads(capsys.readouterr().out)
    assert body["divergent_cycle"] == cycle
    with open(artifact, encoding="utf-8") as f:
        assert json.load(f)["kind"] == "bind"
    assert jax_main(["audit", wal_base, copy_dir, "--json"]) == 1
    assert strip(json.loads(capsys.readouterr().out)) == strip(body)

    assert port_main(["audit", wal_base, str(tmp_path / "nowhere"),
                      "--device", "cpu"]) == 2
    assert "no wal.jsonl in" in capsys.readouterr().err


def test_cross_package_pairs(tmp_path):
    """The same perturbed pair, written once by the JAX package and once
    by the port (the journals equal byte for byte), audited by each
    package: four equal reports."""
    pairs = {}
    for name, run in (("jax", lambda d: jax_stream(
            **CFG, checkpoint_dir=d, checkpoint_every=0)),
            ("port", lambda d: run_stream_simulation(
                **CFG, checkpoint_dir=d, checkpoint_every=0,
                device="cpu"))):
        base = str(tmp_path / f"{name}-a")
        run(base)
        other = _copy(base, tmp_path, f"{name}-b")
        _flip_bind(other)
        pairs[name] = (base, other)
    with open(os.path.join(pairs["jax"][0], StreamPersistence.WAL)) as f:
        jax_wal = f.read()
    with open(os.path.join(pairs["port"][0], StreamPersistence.WAL)) as f:
        assert f.read() == jax_wal
    reports = []
    for a, b in pairs.values():
        for audit in (port_audit, jax_audit):
            report = strip(audit(a, b, explain_k=3))
            report["a"], report["b"] = "a", "b"
            reports.append(report)
    assert reports[0]["kind"] == "bind"
    assert reports[0]["replay_agrees_with"] == "a"
    assert all(r == reports[0] for r in reports[1:])
