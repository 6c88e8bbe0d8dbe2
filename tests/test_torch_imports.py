"""Import guard: every module of the port imports without JAX, the JAX
package or ``__graft_entry__``, and no module imports Triton at import
time.  Runs in a fresh interpreter (the
test process itself has JAX loaded by conftest).  A static scan of every
source line of the port and of ``chip_smoke.py`` catches imports made
inside functions too."""

import json
import os
import pkgutil
import re
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
            "irotavg_tpu_torch.entry",
            "irotavg_tpu_torch.frontend.prefetch",
            "irotavg_tpu_torch.pipeline.offline",
            "irotavg_tpu_torch.app.irotavg_batch",
            "irotavg_tpu_torch.parallel.sharded",
            "irotavg_tpu_torch.parallel.scaling_probe"} <= set(out["names"])
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


# an import statement of JAX or of the JAX package, anywhere in a line
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|irotavg_tpu)(\.|\s|$)")


def _sources():
    port = os.path.join(REPO, "irotavg_tpu_torch")
    for root, _, files in os.walk(port):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_static_scan_finds_no_jax_import():
    """No line of the port or of chip_smoke.py imports JAX or the JAX
    package, at module level or inside a function."""
    hits, n_files = [], 0
    for path in _sources():
        n_files += 1
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                if _FORBIDDEN.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{no}: "
                                f"{line.strip()}")
    assert n_files >= 50
    assert hits == []


def test_static_scan_pattern_catches_function_level_imports():
    for bad in ("    import jax", "import jax.numpy as jnp",
                "        from jax import lax",
                "    from irotavg_tpu.frontend.orb import ORBExtractor",
                "import irotavg_tpu", "from irotavg_tpu import so3"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("from irotavg_tpu_torch.frontend.orb import ORBExtractor",
               "import irotavg_tpu_torch", "    import torch",
               "# see irotavg_tpu/frontend/prefetch.py",
               "from irotavg_tpu_torch import so3"):
        assert not _FORBIDDEN.search(ok), ok
