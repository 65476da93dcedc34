"""What a run and its reference load: never JAX or the JAX package (by
whole top-level names: the port's begins with the JAX package's), and the
reference nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT
REFERENCE = os.path.join(ROOT, "portbench", "reference")
PROGRAM = "consensus_clustering_tpu_torch"


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_nor_the_jax_package():
    tops = _run(
        "import json, sys\n"
        "from portbench import harness\n"
        "harness.set_environment()\n"
        "from portbench.tests.conftest import small_cell\n"
        "r = harness.run_cell(small_cell('blobs20k_stream', n=300, h=6),\n"
        "                     7, 0.0, True, device='cpu')\n"
        "import portbench.control\n"
        "print(json.dumps({'correct': r['correct'], 'tops': sorted({m.split"
        "('.')[0] for m in sys.modules})}))\n")
    assert tops["correct"] is True
    assert PROGRAM in tops["tops"]
    assert not set(tops["tops"]) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _run(
        "import json, sys\n"
        "import portbench.reference.consensus, portbench.reference.blobs\n"
        "import portbench.check, portbench.control, portbench.peaks\n"
        "print(json.dumps({'tops': sorted({m.split('.')[0] for m in "
        "sys.modules})}))\n")["tops"]
    assert PROGRAM not in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_the_reference_sources_import_only_numpy_torch_and_itself():
    allowed = {"__future__", "contextlib", "math", "typing", "numpy",
               "torch", "portbench"}
    # Subdirectories too: the lane clusterers and data generators that
    # configurations add under reference/clusterers/ and reference/data/.
    for name in [os.path.relpath(os.path.join(d, f), REFERENCE)
                 for d, _, files in os.walk(REFERENCE) for f in files]:
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REFERENCE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top in allowed, f"{name} imports {mod}"
                if top == "portbench":
                    assert mod.startswith("portbench.reference"), mod


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "consensus_clustering_tpu_torchx", None)
    assert "consensus_clustering_tpu_torchx" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert harness.forbidden_modules() == ["jax.numpy"]
