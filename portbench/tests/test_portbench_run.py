"""``run.py`` fails, and prints no result, where it cannot run a cell:
no card visible, or a directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent


def _run(cwd, env=None):
    cmd = [sys.executable, "portbench/run.py", "--workload", "emis_table", "--seed", "2147483659",
           "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _printed_a_result(stdout):
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (json.JSONDecodeError, TypeError):
            continue
    return False


def test_run_fails_without_a_card():
    proc = _run(ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert not _printed_a_result(proc.stdout)
    assert "CUDA device" in proc.stderr


def test_run_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _printed_a_result(proc.stdout)


def test_unknown_workload_fails():
    cmd = [sys.executable, "portbench/run.py", "--workload", "nope", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not _printed_a_result(proc.stdout)


def test_run_sets_the_configurations_host_threads(monkeypatch):
    import torch

    from portbench import harness

    set_to = []
    monkeypatch.setattr(torch, "set_num_threads", set_to.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--seed", "1", "--seconds", "1", "--trace", "0", "--workload"]
    assert harness.main(argv + ["emis_table"], 0.0) != 0
    assert set_to == [1]  # emissivity_lamppost's host_threads
    assert harness.main(argv + ["image_isco_incl"], 0.0) != 0
    assert set_to == [1]  # disc_image_isco keeps torch's default


@pytest.mark.cuda
def test_run_prints_a_correct_result_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = _run(ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"rays_per_s", "job_p95_ms", "setup_s"}
    assert line["device"]["kind"].startswith("NVIDIA")
