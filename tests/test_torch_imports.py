"""Import guard: every module of the port imports without JAX, the JAX
package or ``__graft_entry__``, and no module imports Triton at import
time.  Runs in a fresh interpreter (the
test process itself has JAX loaded by conftest)."""

import json
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import irotavg_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "irotavg_tpu",
                                    "__graft_entry__"))
print(json.dumps({"modules": len(names), "names": names, "bad": bad}))
"""


def _module_count():
    import irotavg_tpu_torch

    return len(list(pkgutil.walk_packages(irotavg_tpu_torch.__path__,
                                          "irotavg_tpu_torch.")))


def test_port_imports_without_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["modules"] == _module_count() >= 45
    assert {"irotavg_tpu_torch.placerec.vocabulary",
            "irotavg_tpu_torch.placerec.database",
            "irotavg_tpu_torch.placerec.bow",
            "irotavg_tpu_torch.solver.io", "irotavg_tpu_torch.solver.init",
            "irotavg_tpu_torch.engine.batched",
            "irotavg_tpu_torch.engine.checkpoint",
            "irotavg_tpu_torch.app.l1_irls",
            "irotavg_tpu_torch.entry"} <= set(out["names"])
    assert out["bad"] == [], f"imported at import time: {out['bad']}"


def test_chip_smoke_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    probe = ("import sys, chip_smoke; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'triton', 'irotavg_tpu', "
             "'__graft_entry__')))")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
