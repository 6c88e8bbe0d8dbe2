"""The harness finds a configuration, a traffic mix and a per-layer metric
by name, as files alone, and prints a result line with exactly the
contract's keys.  Runs a copy of the benchmark on the CPU (the command
itself refuses a machine without a card, so the run goes through
``pbkit.runner``) on a small problem written by the test."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

DRIVE = """
import json, sys
sys.path.insert(0, {pb!r}); sys.path.insert(0, {repo!r})
import torch
from pbkit import runner, spec
cell = spec.load_cell("tiny_chain.solve", {bench!r})
out = runner.run_cell(cell, 2 ** 31 + 5, 0.5, bool({trace}),
                      torch.device("cpu"))
print(runner.dumps(out))
"""


def _problem(path, n=8):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = (0, 0, 0, 1)
    edges = [(i, j) for i in range(n) for j in range(i + 1, min(n, i + 3))]
    lines = [f"{len(edges)} {n} 1"]
    for i, j in edges:
        qi = q[i] * [-1, -1, -1, 1]
        x1, y1, z1, w1 = q[j]
        x2, y2, z2, w2 = qi
        r = [w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
             w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
             w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
             w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2]
        lines.append(f"{i} {j} " + " ".join(repr(float(v)) for v in
                                            (r[3], r[0], r[1], r[2])))
    lines.append("1 0 0 0")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    sha = _problem(root / "tiny.txt")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    golden = json.load(open(pb / "configs" / "ral_golden.json"))
    golden.update(name="tiny_chain",
                  problem={"file": "tiny.txt", "sha256": sha})
    json.dump(golden, open(pb / "configs" / "tiny_chain.json", "w"))
    traffic = json.load(open(pb / "traffic" / "solve.json"))
    traffic.update(relabellings=3, warmup_solves=1, check_solves=2,
                   limits={"init_gap": 0.0, "l1ra_gap_deg": 1e-6,
                           "irls_gap_deg": 1e-6, "weight_gap": 1e-6})
    json.dump(traffic, open(pb / "traffic" / "tiny_solve.json", "w"))
    (pb / "layers" / "solves_counted.py").write_text(
        "WRAP = {}\n\n\ndef read(r):\n    return float(r.units['solves'])\n")
    bench["configs"].append({"name": "tiny_chain", "source": "a test",
                             "file": "portbench/configs/tiny_chain.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"] = [{"name": "tiny_chain.solve",
                           "config": "tiny_chain", "traffic": "tiny_solve",
                           "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_chain.solve"] if m["name"] == \
                "solve_ms" else []
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny_chain.solve"] if m["name"] in (
            "l1ra_ms", "irls_ms") else []
    bench["per_layer"].append({"name": "solves_counted", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "solver", "moves": "solve_ms",
                               "workloads": ["tiny_chain.solve"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return root


def _drive(root, trace):
    code = DRIVE.format(pb=str(root / "portbench"), repo=ROOT,
                        bench=str(root / "BENCHMARK.json"), trace=trace)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr


def test_added_files_are_found_by_name_and_the_line_has_the_keys(tmp_path):
    root = _checkout(tmp_path)
    out, err = _drive(root, 0)
    assert list(out) == KEYS + ["compared"]
    assert out["correct"] is True and out["failed"] == 0, out["compared"]
    assert set(out["metrics"]) == {"solve_ms", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert err.strip().splitlines()[-1].startswith("compared weight_gap ")
    traced, _ = _drive(root, 1)
    assert list(traced) == KEYS + ["breakdown", "compared"]
    assert traced["metrics"]["solves_counted"]["value"] >= 1
    assert set(traced["metrics"]) == {"l1ra_ms", "irls_ms",
                                      "solves_counted"}
    assert {"busy_s", "window_s"} <= set(traced["device"])
