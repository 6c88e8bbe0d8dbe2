"""No module of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program; the command refuses a machine
without a card."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

FORBIDDEN = {"jax", "jaxlib", "flax", "irotavg_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules()}
    assert {p: b for p, b in bad.items() if b} == {}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_imports(os.path.join(ref, f)))
            assert not tops & (FORBIDDEN | {"irotavg_tpu_torch"}), f


def test_names_compared_whole():
    sys.path.insert(0, HERE)
    from pbkit import runner

    sys.modules.setdefault("irotavg_tpu_torch_fixture_name", sys)
    assert "irotavg_tpu" not in runner.forbidden_modules()


def test_command_refuses_a_machine_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        return
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ral_golden.solve", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 2
    assert "{" not in r.stdout


@pytest.mark.card
def test_command_on_a_card(card, tmp_path):
    """The command end to end on the card: a short golden run is correct
    and its line names the card."""
    import json

    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ral_golden.solve", "--seed", str(2 ** 31 + 3),
                        "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
