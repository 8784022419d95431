"""What the harness loads: no module of JAX, flax, optax or the JAX
package, compared by whole top-level name; and a reference that imports
nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "coma_unet_tpu_torch_probe.x", sys)
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "coma_unet_tpu.models", sys)
    assert harness.forbidden_modules() == ["coma_unet_tpu"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in harness.FORBIDDEN + ("coma_unet_tpu_torch",), (path, name)


SCRIPT = """
import json, sys, time, torch
from perfbench import harness
tiny = json.loads(sys.argv[1])
for cell in ("contra.train_rnc.128", "attnunet.train.128", "contra.infer.216"):
    for trace in (False, True):
        harness.run_cell(cell, 2 ** 31 + 11, 0.2, trace, torch.device("cpu"),
                         time.perf_counter(), overrides=tiny)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_whole_run_loads_no_jax(tiny, tmp_path):
    env = {"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
           "PYTHONPATH": str(ROOT), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(tiny)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "coma_unet_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
