"""The port's multi-process wiring (parallel/multihost.py) and the CLI's
--dist-* flags, on the CPU (gloo): with nothing configured a run is
single-process, a partial configuration and an unreachable coordinator
raise (no fallback to a single-process run, unlike the JAX module's
auto-detection), and two CLI processes joined by --dist-* each print their
process summary and solve as the single-process CLI does."""

import os
import socket
import subprocess
import sys
import time

import pytest

from slam_plus_plus_tpu_torch.app import main as tmain
from slam_plus_plus_tpu_torch.io import datasets as tds
from slam_plus_plus_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAMPP_ENV = ("SLAMPP_COORD", "SLAMPP_NPROCS", "SLAMPP_PROC_ID")


@pytest.fixture
def no_slampp_env(monkeypatch):
    for k in SLAMPP_ENV:
        monkeypatch.delenv(k, raising=False)


def test_nothing_configured_is_single_process(no_slampp_env):
    import torch.distributed as dist

    assert multihost.initialize(device="cpu") is False
    assert not dist.is_initialized() and not multihost.is_multiprocess()
    assert multihost.process_summary().startswith("process 0/1")
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"


@pytest.mark.parametrize("args", [("127.0.0.1:1", None, 0), (None, 2, 0), ("127.0.0.1:1", 2, None),
                                  ("127.0.0.1:1", 2, 2)],
                         ids=["no-count", "no-coordinator", "no-id", "id-out-of-range"])
def test_partial_configuration_raises(no_slampp_env, args):
    with pytest.raises(ValueError):
        multihost.initialize(*args, device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dead_coordinator_raises_within_timeout():
    """Process 1 of 2 pointed at a port where nothing listens (through the
    SLAMPP_* variables) raises within about twice its 3 s timeout (the
    store's connect retries), in its own process."""
    env = dict(os.environ, SLAMPP_COORD=f"127.0.0.1:{_free_port()}", SLAMPP_NPROCS="2",
               SLAMPP_PROC_ID="1")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from slam_plus_plus_tpu_torch.parallel import multihost\n"
            "multihost.initialize(device='cpu', timeout_s=3)\n" % REPO)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    took = time.perf_counter() - t0
    assert res.returncode != 0 and "Error" in res.stderr, res.stderr[-2000:]
    assert took < 30, took


def test_two_cli_processes_match_the_single_process_run(tmp_path, no_slampp_env, capsys):
    """Two CLI processes joined through --dist-* (a file:// rendezvous,
    --device cpu): each prints its process summary and exits 0 with the
    single-process CLI's final chi2."""
    path = str(tmp_path / "ba.g2o")
    tds.write_g2o_ba(path, *tds.make_ba_scene(n_cams=6, n_points=60, seed=3))
    chi2, iters, _solver = tmain.run(tmain.build_argparser().parse_args(
        ["-i", path, "--device", "cpu", "-s", "-dx", "", "-nb"]))
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slam_plus_plus_tpu_torch.app.main", "-i", path, "--device", "cpu",
         "-dx", "", "-nb", "--dist-coord", f"file://{store}", "--dist-nprocs", "2",
         "--dist-procid", str(r)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"process {r}/2, backend gloo" in out, out
        assert f"solver took {iters} iterations" in out, out
        assert f"denormalized chi2 error: {chi2:.2f}" in out, out
