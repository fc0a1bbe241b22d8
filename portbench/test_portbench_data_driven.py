"""What a later change may add by files alone: a traffic mix, a cell, a
per-layer metric and its limits, picked up by name from BENCHMARK.json in
a copy of the benchmark with no file edited; and what a run may load."""

import json
import os
import shutil
import subprocess
import sys

from portbench.tiny import ROOT

NEW_METRIC = '''"""Device busy ms inside the program's ``moe/combine`` range, per batch."""

from portbench import readers

LAYER = "MoE (models/moe.py)"
UNIT = "ms"
MOVES = "prefill_tok_s"
SOURCE = "program_span"


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, ("moe/combine",))
'''

RUN_NEW_CELL = '''
import json, sys
from pathlib import Path
from portbench import harness, tiny
c = tiny.cell("granite-moe-1b-a400m.prefill_odd", root=Path("."))
out = harness.run(c, 77, 0.3, False, device="cpu")
print(json.dumps({"batch": c.traffic["batch"], "per_layer": [m["name"] for m in c.per_layer],
                  "reader": harness.load_reader("combine_ms.prefill").UNIT,
                  "harness": harness.__file__, "correct": out["correct"],
                  "metrics": sorted(out["metrics"])}))
'''


def env(*paths):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(map(str, paths)))


def test_a_mix_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = "granite-moe-1b-a400m.prefill_odd"
    man["workloads"].append({"name": name, "config": "granite-moe-1b-a400m",
                             "traffic": "prefill_odd", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] in ("prefill_tok_s", "ttft_p95_ms"):
            m["workloads"].append(name)
    man["per_layer"].append({"name": "combine_ms.prefill", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "MoE (models/moe.py)",
                             "moves": "prefill_tok_s", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (bench / "traffic" / "prefill_odd.json").write_text(json.dumps(
        {"kind": "prefill", "batch": 3, "lengths": [8, 40], "check_requests": 6}))
    (bench / "metrics" / "combine_ms.prefill.py").write_text(NEW_METRIC)
    (bench / "limits" / f"{name}.json").write_text(json.dumps({"logit_gap": 0.1}))
    proc = subprocess.run([sys.executable, "-c", RUN_NEW_CELL], cwd=tmp_path, timeout=240,
                          env=env(tmp_path, ROOT / "src"), capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["harness"].startswith(str(tmp_path))
    assert got["batch"] == 3
    assert "combine_ms.prefill" in got["per_layer"] and got["reader"] == "ms"
    assert got["correct"] and got["metrics"] == ["prefill_tok_s", "setup_s", "ttft_p95_ms"]


RUN_CELLS = '''
import json, sys
import portbench.run
from portbench import harness, tiny
for w in ("granite-moe-1b-a400m.train_4k", "h2o-danube-3-4b.prefill_short"):
    harness.run(tiny.cell(w), 5, 0.2, False, device="cpu")
print(json.dumps({"forbidden": harness.forbidden_loaded(),
                  "port": "repro_torch" in sys.modules}))
'''

IMPORT_REFERENCE = '''
import json, sys
import portbench.reference.model, portbench.weights, portbench.counts
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & {"repro_torch", "repro", "jax", "jaxlib", "flax"})))
'''


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    for code in (RUN_CELLS, IMPORT_REFERENCE):
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=240,
                              env=env(ROOT, ROOT / "src"), capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        if code is RUN_CELLS:
            assert got == {"forbidden": [], "port": True}
        else:
            assert got == []
