"""The port's CLI as k ranks of a launcher (python -m torch.distributed.run,
torchrun) with TPUSIM_SHARDS=k, on the CPU.

`stream` and the main command, each started as 2 ranks: the ranks join the
launcher's group over gloo, the stream's twin is sharded over them (the
metrics dump counts 2 shards), rank 0 alone prints the report and writes
the files the user named, each rank journals to its own directory, and
the report equals the single-device command's (its placement chain and the
main command's lines, timing aside). Without a launcher, TPUSIM_SHARDS=2
leaves the command as it was, the declined batch counted under
device_count. Tolerance: exact.
"""

import json
import os
import re
import subprocess
import sys

from tpusim_torch.cli import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = ["stream", "--synthetic-nodes", "14", "--cycles", "4",
          "--arrivals", "6", "--flap-every", "3", "--device", "cpu"]
PODSPEC = [{"name": "small", "num": 10, "pod": {
    "metadata": {"labels": {"app": "app0"}},
    "spec": {"containers": [{"resources": {"requests": {
        "cpu": "700m", "memory": "1Gi"}}}]}}}]
MAIN = ["--synthetic-nodes", "4", "--device", "cpu"]
# the wall times of a report line
TIMING = re.compile(r"\d+(\.\d+)?(s| decisions/s| ms|/\d+\.\d+ ms| pods/s)")


def launch(argv, ranks=2):
    """`python -m torch.distributed.run --nproc-per-node ranks -m
    tpusim_torch.cli argv` with TPUSIM_SHARDS=ranks, started now."""
    env = dict(os.environ, TPUSIM_SHARDS=str(ranks),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={ranks}", "-m", "tpusim_torch.cli", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(proc, timeout=180):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def lines(text):
    return [TIMING.sub("", line) for line in text.splitlines()]


def test_cli_under_two_ranks(tmp_path, capsys, monkeypatch):
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps(PODSPEC))
    ck = str(tmp_path / "ck")
    metrics = str(tmp_path / "m.prom")
    # both launches at once
    stream = launch(STREAM + ["--checkpoint-dir", ck, "--checkpoint-every",
                              "2", "--metrics-out", metrics])
    main = launch(["--podspec", str(spec)] + MAIN)
    got_stream, got_main = finish(stream), finish(main)

    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    assert port_main(STREAM + ["--checkpoint-dir", str(tmp_path / "one"),
                               "--checkpoint-every", "2"]) == 0
    want_stream = capsys.readouterr().out
    assert port_main(["--podspec", str(spec)] + MAIN) == 0
    want_main = capsys.readouterr().out

    # one report, rank 0's, with the single-device chains
    assert lines(got_stream) == lines(want_stream)
    assert got_stream.count("placement chain") == 1
    assert "fold chain" in got_stream
    assert lines(got_main) == lines(want_main)
    assert got_main.count("pod(s) scheduled") == 1
    # the twin was sharded over the 2 ranks, in rank 0's dump
    with open(metrics) as f:
        dump = f.read()
    assert "tpusim_shard_count 2" in dump
    assert 'tpusim_shard_node_occupancy{shard="1"} 7' in dump
    # rank r journals to <dir>.rank<r>: the same WAL bytes
    with open(os.path.join(ck, "wal.jsonl"), "rb") as f:
        wal0 = f.read()
    with open(os.path.join(ck + ".rank1", "wal.jsonl"), "rb") as f:
        assert f.read() == wal0
    with open(os.path.join(str(tmp_path / "one"), "wal.jsonl"), "rb") as f:
        assert f.read() == wal0
    with open(os.path.join(ck, "checkpoint.json")) as f:
        assert json.load(f)["shard_layout"] == {
            "shards": 2, "nodes": 14, "nodes_per_shard": 7}


def test_cli_without_a_launcher_counts_device_count(tmp_path, capsys,
                                                     monkeypatch):
    metrics = str(tmp_path / "m.prom")
    monkeypatch.delenv("TPUSIM_SHARDS", raising=False)
    assert port_main(STREAM) == 0
    want = capsys.readouterr().out
    monkeypatch.setenv("TPUSIM_SHARDS", "2")
    assert port_main(STREAM + ["--metrics-out", metrics]) == 0
    assert lines(capsys.readouterr().out) == lines(want)
    with open(metrics) as f:
        dump = f.read()
    assert 'tpusim_shard_fallback_total{reason="device_count"}' in dump
