"""The command's refusals: no result without a card, and no run in a
directory that holds the benchmark alone."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


def _env(tmp_path):
    return {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
            "TMPDIR": str(tmp_path), "CUDA_VISIBLE_DEVICES": "",
            "BENCH_RUN": "1"}


def test_no_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELL,
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path, tiny):
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "perfbench", alone / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    script = ("import json, sys, time, torch; from perfbench import harness; "
              "r = harness.run_cell(sys.argv[1], 5, 0.1, False, "
              "torch.device('cpu'), time.perf_counter(), "
              "overrides=json.loads(sys.argv[2])); print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", script, CELL, json.dumps(tiny)],
                         cwd=alone, env=dict(_env(tmp_path), PYTHONPATH=str(alone)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "coma_unet_tpu_torch" in out.stderr
