"""The benchmark's driver, read from data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds ``configs/<config>.json``, ``traffic/<mix>.json`` and
``limits/<cell>.json`` by those names, runs the traffic's kind
(``kinds/<kind>.py``: set-up, a measured window, a profiled stretch, the
check against the reference) and reads each per-layer metric of the cell
with its own reader, ``metrics/<metric>.py``.  Adding a configuration, a
mix, a cell or a metric of an existing kind adds files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: top-level modules that may not be loaded in a run (compared whole: the
#: program's own package name begins with the second)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, man: dict, workload: str) -> bool:
    """Whether ``metric`` is reported in ``workload``: its ``workloads`` list
    names the cell, or it has none and the cell reports the end-to-end
    metric it moves (per-layer) or it has none at all (end-to-end)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        e2e = {m["name"]: m for m in man["end_to_end"]}
        return applies(e2e[metric["moves"]], man, workload)
    return True


def load_reader(name: str):
    """The per-layer metric reader ``metrics/<name>.py`` (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


class Cell:
    """What one run of one cell needs: its entry, configuration, traffic,
    limits and metrics.  ``cfg_overrides`` / ``traffic_overrides`` shrink a
    cell for the CPU tests."""

    def __init__(self, root: Path, workload: str, cfg_overrides=None, traffic_overrides=None):
        self.root = Path(root)
        self.man = manifest(self.root)
        self.entry = cell(self.man, workload)
        self.name = workload
        self.cfg = dict(load_json(HERE / "configs" / f"{self.entry['config']}.json"),
                        **(cfg_overrides or {}))
        self.traffic = dict(load_json(HERE / "traffic" / f"{self.entry['traffic']}.json"),
                            **(traffic_overrides or {}))
        self.limits = load_json(HERE / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in self.man["end_to_end"] if applies(m, self.man, workload)]
        self.per_layer = [m for m in self.man["per_layer"] if applies(m, self.man, workload)]


def judge(readings: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} for every number the check read."""
    return {name: {"value": value, "limit": limits.get(name)} for name, value in readings.items()}


def is_correct(judged: dict) -> bool:
    """Every number is finite and within its limit; one with no limit fails."""
    return bool(judged) and all(
        v["limit"] is not None and math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in judged.values())


def run(c: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, out_dir: Path | None = None) -> dict:
    """One run of cell ``c``: set-up, the measured window, with ``trace``
    the profiled stretch and the per-layer metrics, then the check.
    Returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    bench = kind_module(c.traffic["kind"]).Bench(c, seed, torch.device(device))
    t_setup = time.perf_counter()
    bench.setup()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: imports {t_setup - t_start:.3f} s, " + ", ".join(
        f"{k} {v:.3f} s" for k, v in bench.phases.items()), file=sys.stderr, flush=True)
    cuda = bench.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    e2e = bench.window(seconds)
    e2e["setup_s"] = setup_s
    metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in c.end_to_end}
    device_info = {"platform": "gpu" if cuda else device,
                   "kind": torch.cuda.get_device_name() if cuda else device, "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    breakdown = None
    if trace:
        tr = bench.profile()
        metrics = {}
        for m in c.per_layer:
            value = load_reader(m["name"]).read(bench, tr)
            if value is None:
                # a metric listed for the cell is due on its traced line
                print(f"portbench: {m['name']} found nothing to read in the trace "
                      f"(its ranges or kernel names, or one profiled call's range, are "
                      f"missing), and the line leaves it out", file=sys.stderr, flush=True)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.wall_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / "profile.txt").write_text(tr.table)
        if cuda:
            device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    bench.release()
    readings = bench.check()
    judged = judge(readings, c.limits)
    out = {"correct": is_correct(judged), "attempted": bench.attempted, "failed": bench.failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = judged
    return out
