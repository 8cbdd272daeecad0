"""The run's result line on its error paths, and the paths that print no
result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "bench_port/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_an_error_still_ends_in_a_result_line():
    out = _run(ROOT, "--workload", "no.such.cell", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= set(last) and last["correct"] is False


def test_no_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT, "--workload", "cvaegan.fit.strict", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode not in (0, None)
    assert out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path, "--workload", "cvaegan.fit.strict", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
