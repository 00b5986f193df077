"""The port's --mesh flags on the CPU: `--what-if --mesh SNAPxNODE` and
`serve --mesh SCENARIOxNODE`, without a launcher (a mesh of one rank on a
group the command makes) and as 2 ranks of python -m
torch.distributed.run, against the single-device command's lines (timing
and the fleet line's mesh suffix aside); and the refusals, rc 2 with the
JAX package's words ("ranks" where it says "devices"). Tolerance: exact.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from tpusim.cli import main as jax_main

from tpusim_torch.cli import main as port_main
import torch_mesh_workers as MW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the wall times of a report line
TIMING = re.compile(r"[\d./]+( ms|s| scenarios/s| pods/s)")
PODSPEC = [{"name": "w", "num": 5, "pod": {
    "metadata": {"name": "w"},
    "spec": {"containers": [{"name": "c", "resources": {"requests": {
        "cpu": "500m", "memory": "128Mi"}}}]}}}]
SERVE = ["serve", "--synthetic-nodes", "8", "--requests", "8",
         "--bucket-size", "2", "--flush-after-ms", "0", "--device", "cpu"]


@pytest.fixture
def files(tmp_path):
    """A three-scenario manifest (the provider mesh scenarios) and a
    podspec, as JSON."""
    spec = tmp_path / "pods.json"
    spec.write_text(json.dumps(PODSPEC))
    manifest = []
    for i, (snap, _) in enumerate(MW.provider_scenarios("port")):
        path = tmp_path / f"snap{i}.json"
        snap.save(str(path))
        manifest.append({"snapshot": str(path), "podspec": str(spec)})
    mpath = tmp_path / "manifest.json"
    mpath.write_text(json.dumps(manifest))
    return str(mpath), str(spec)


def lines(text):
    return [TIMING.sub("", line).replace(", mesh 1x1", "")
            .replace(", mesh 2x1", "") for line in text.splitlines()]


def test_what_if_mesh_of_one_rank(files, capsys):
    manifest, _ = files
    assert port_main(["--what-if", manifest, "--device", "cpu"]) == 0
    plain = capsys.readouterr().out
    assert port_main(["--what-if", manifest, "--device", "cpu",
                      "--mesh", "1x1"]) == 0
    meshed = capsys.readouterr().out
    assert lines(meshed) == lines(plain)
    assert plain.count("scenario ") == 3


def test_serve_mesh_of_one_rank(files, capsys):
    _, spec = files
    assert port_main(SERVE + ["--podspec", spec]) == 0
    plain = capsys.readouterr().out
    assert port_main(SERVE + ["--podspec", spec, "--mesh", "1"]) == 0
    meshed = capsys.readouterr().out
    assert lines(meshed) == lines(plain)
    assert meshed.splitlines()[-1].endswith(", mesh 1x1")


@pytest.mark.parametrize("argv,words", [
    (["--mesh", "bogus"], "want 'SNAPxNODE', e.g. 2x4"),
    (["--mesh", "2x1"], "needs 2 ranks, 1 visible"),
    (["--mesh", "999x9"], "needs 8991 ranks, 1 visible"),
])
def test_what_if_mesh_refusals(files, capsys, argv, words):
    manifest, _ = files
    assert port_main(["--what-if", manifest, "--device", "cpu"]
                     + argv) == 2
    assert words in capsys.readouterr().err


@pytest.mark.parametrize("argv,words", [
    (["--mesh", "x"], "want 'SCENARIOxNODE' (e.g. 8x1) or 'SCENARIO'"),
    (["--mesh", "2"], "needs 2 ranks, 1 visible"),
])
def test_serve_mesh_refusals(files, capsys, argv, words):
    _, spec = files
    assert port_main(SERVE + ["--podspec", spec] + argv) == 2
    assert words in capsys.readouterr().err


def test_mesh_needs_what_if(capsys):
    argv = ["--podspec", "x.yaml", "--mesh", "2x4"]
    assert jax_main(argv) == 2
    want = capsys.readouterr().err
    assert port_main(argv) == 2
    assert capsys.readouterr().err == want
    assert "--mesh applies only to --what-if" in want


def launch(argv, ranks=2):
    """`python -m torch.distributed.run --nproc-per-node ranks -m
    tpusim_torch.cli argv`, started now."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("TPUSIM_SHARDS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={ranks}", "-m", "tpusim_torch.cli", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(proc, timeout=180):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def test_mesh_commands_under_two_ranks(files, capsys):
    manifest, spec = files
    what_if = launch(["--what-if", manifest, "--device", "cpu",
                      "--mesh", "2x1"])
    serve = launch(SERVE + ["--podspec", spec, "--mesh", "2"])
    got_what_if, got_serve = finish(what_if), finish(serve)

    assert port_main(["--what-if", manifest, "--device", "cpu"]) == 0
    want_what_if = capsys.readouterr().out
    assert port_main(SERVE + ["--podspec", spec]) == 0
    want_serve = capsys.readouterr().out
    # one report, rank 0's, equal to the single-device command's
    assert lines(got_what_if) == lines(want_what_if)
    assert got_what_if.count("scenario 0:") == 1
    assert lines(got_serve) == lines(want_serve)
    assert got_serve.count("fleet:") == 1
    assert got_serve.splitlines()[-1].endswith(", mesh 2x1")
