"""Cells shrunk to a size the CPU tests hold: the same kinds, mixes and
limits at small widths, in fp32."""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SIZES = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
             vocab_size=256, param_dtype="float32", compute_dtype="float32")
MOE = {"n_experts": 4, "top_k": 2, "capacity_factor": 1.25, "aux_weight": 0.01}
TRAFFIC = {"train": dict(batch=2, seq_len=32, records=16),
           "prefill": dict(lengths=[16, 24, 32], check_requests=32)}


def cfg_overrides(cfg: dict) -> dict:
    out = dict(SIZES)
    if cfg.get("moe") is not None:
        out["moe"] = MOE
    if cfg.get("swa_window") is not None:
        out["swa_window"] = 16
    return out


def cell(workload: str, root: Path = ROOT, **traffic):
    """The cell ``workload`` at the tiny size (``traffic`` overrides more)."""
    from portbench import harness

    c = harness.Cell(root, workload)
    return harness.Cell(root, workload, cfg_overrides=cfg_overrides(c.cfg),
                        traffic_overrides={**TRAFFIC[c.traffic["kind"]], **traffic})
