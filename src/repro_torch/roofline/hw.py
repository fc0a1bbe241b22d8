"""Hardware models, after ``repro/roofline/hw.py``: the reference's TPU
v5e, and the NVIDIA H100 the port runs on.

Every figure here is a datasheet figure, not a measurement.  ``HW_H100``
is the H100 SXM5 80 GB at its 700 W limit: bf16 dense tensor-core peak
989e12 FLOP/s and HBM3 at 3.35e12 B/s (the figures ``chip_smoke.py``'s
bounds use), 80 GB of HBM, NVLink 4 at 450e9 B/s a direction a GPU in
place of the TPU's ICI link, and InfiniBand NDR at 400 Gb/s = 50e9 B/s a
GPU in place of its DCN share.  A node holds 8 GPUs on one NVLink
switch, so a 16-wide mesh axis crosses nodes: there the collective term,
taken over NVLink, is optimistic by up to 450e9 / 50e9 = 9x.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops_bf16: float   # per chip
    hbm_bw: float            # per chip, B/s
    hbm_bytes: float         # per chip
    ici_bw_per_link: float   # B/s, one ICI link (the H100: NVLink, one direction)
    ici_links: int           # usable links per chip (2D torus)
    dcn_bw: float            # per-chip share of inter-pod DCN, B/s


HW_V5E = Hardware(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * 1024**3,
    ici_bw_per_link=50e9,   # per assignment: ~50 GB/s/link
    ici_links=1,            # conservative single-link roofline term
    dcn_bw=6.25e9,          # ~50 Gb/s per-chip DCN share across pods
)

HW_H100 = Hardware(
    name="h100-sxm5-80gb",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * 1024**3,  # 80 GB as memory is sold: GiB
    ici_bw_per_link=450e9,  # NVLink 4: 900 GB/s a GPU, both directions
    ici_links=1,
    dcn_bw=50e9,            # InfiniBand NDR, 400 Gb/s a GPU
)
