#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch`` (``nvcc``,
   one process per source, all at once);
3. holds each kernel against its plain PyTorch version on the card:
   flash attention (``kernel_check``: the TMA / wgmma path on every bf16
   case it can describe, the mma.sync path on a head dim of 20 and on views
   one element off 16-byte alignment, the fp32 path; then the
   ``attn_accum_bf16`` mode of the mma.sync and fp32 kernels on the
   kernel module's ACC_CASES, the served prefill's shape among them,
   against the plain chunked form with ``accum_bf16`` and fp32 truth; then
   the backward kernel through ``FlashAttention`` at the training steps'
   shapes against the plain backward), the lanesum32 checksum
   (``checksum_check``, bit-exact, a buffer above 2 GiB included) and the
   ssm_scan recurrence (``ssm_check``: tests/test_kernels.py's cases,
   strong and scalar decay, the chunked kernel's edges (T 1 and 17, a
   decay of about -20 a step, K 128 and 18), the full-width rwkv6 head
   shape at T 300, 512 and 5120, y and the final state) and the Mamba-1
   selective scan (``selective_scan_check``: at the published Jamba's
   width, d_inner 8192 and d_state 16, B1 T 16384 and 65536, y and the
   final state against the plain chunked form, device memory growing by y
   and the state only);
4. times each kernel, its plain version and its bound at the main-path
   shapes (``kernel_times``, ``checksum_times``, ``ssm_times``,
   ``selective_scan_times``); for the scans and flash attention also the
   device time per call from
   ``torch.profiler``, for flash of the kernel and SDPA alike, and their
   ratio (where the window cuts, SDPA with the band as a mask computes the
   kernel's function, and SDPA with ``is_causal`` over every causal pair
   is timed beside it); flash's ``attn_accum_bf16`` mode and its plain form
   at the same shapes; the flash backward kernel, the plain backward and
   SDPA's backward at the training steps' shapes (``backward_times``);
5. serves full-width h2o-danube-3-4b (24 layers, bf16, random weights from
   a seed) through ``repro_torch.launch.serve`` (``serve``): 4 requests x
   512-token prompts to 32 tokens, then 1 request x a 5120-token prompt to
   8 tokens, and checks finite logits, 24 flash launches per prefill, all
   on the TMA path, the same greedy first token through the plain
   attention, and logits about as close to an fp32 prefill as the plain
   bf16 prefill's; one profiled prefill gives the device busy time, idle
   share and the flash kernel's share of the busy time; the 4 x 512
   prefill again with ``attn_accum_bf16`` (``serve_accum_bf16``): 24
   launches of the mma.sync kernel's bf16-accumulating instance, logits
   near the plain accum_bf16 prefill's and about as close to the fp32
   prefill as those;
6. serves full-width rwkv6-7b (32 layers, bf16) the same two ways
   (``serve_rwkv``): 32 scan launches per prefill and none per decode step,
   no flash or checksum launch, finite logits; in fp32 compute the kernel
   path's greedy first tokens equal to the plain scan's on every request and
   its logits within FP32_LOGIT_LIMIT of them (a scan fed bf16 inputs must
   land beyond it); bf16 logits as close to an fp32 prefill as the plain
   bf16 prefill's; tokens/s, peak memory, and the device busy time and
   idle share of a profiled prefill and decode step;
7. serves full-width, full-depth granite-moe-1b-a400m (24 MoE layers of 32
   experts, top 8, bf16) the same two ways (``serve_moe``): 24 flash
   launches per prefill, all on the TMA path, finite logits; in fp32
   compute the kernel path's greedy first tokens equal to the plain
   attention's and its logits within MOE_FP32_LOGIT_LIMIT of them (the
   kernel fed bf16-rounded q, k, v must land beyond it); in bf16 the logit
   error against fp32 and the routing decisions that differ from the plain
   run are printed, not gated (top-k routing turns bf16 noise into other
   experts); tokens/s and a profiled prefill;
8. runs one jamba mamba mixer at full width (``mamba_layer``: d_model
   8192, 256 heads of 64, d_state 64) at B4 x T512 and B1 x T5120, then 8
   decode steps: one scan launch per prefill and none per decode step;
   the scan's q and k are C_t and B_t expanded over the heads and g one
   value per (b, t, h), read in place: the kernel's y and state against
   the plain scalar-decay chunked form (fp32 and bf16), bit for bit what
   it gives on contiguous copies, and device memory growing by no more
   than y and the state during the call; its device time and bound at both
   shapes, its share of the layer's prefill, and the memory and time the
   copying call would add;
9. serves jamba scaled down (2 blocks of 7 mamba + 1 attention layer, MoE
   every second layer, fp32) through ``repro_torch.launch.serve``
   (``serve_hybrid``): the scan once per mamba layer and flash once per
   attention layer in a prefill, neither in decode; prefill and decode
   logits against the same model through plain attention and the plain
   scan, within HYBRID_FP32_LOGIT_LIMIT (a scan fed bf16 inputs must land
   beyond it), and the same greedy first tokens; then the published Jamba
   (``serve_jamba2``: AI21-Jamba2-Mini, 16 of 32 layers at full width, bf16,
   the benchmark's configuration and seeded weights) through
   ``registry.build`` and ``steps.make_prefill_step``: 14 selective-scan
   launches (one a Mamba layer) and 2 flash launches on the TMA path in a
   JAMBA2_PROMPT-token prefill, finite logits, the prefill's wall and the
   card's peak memory;
10. serves full-width, full-depth whisper-medium (24 encoder and 24 decoder
   layers, bf16) through ``repro_torch.launch.serve`` (``serve_whisper``):
   4 and then 16 requests, each 1500 audio frames and a 64-token decoder
   prompt, to 32 tokens; 48 flash launches per prefill, all on the TMA
   path (24 non-causal over the frames, 24 causal), the cross-attention
   plain; a profiled prefill with the encoder's, flash's and
   cross-attention's shares of the busy time; in fp32 compute the kernel
   path's greedy first tokens equal to plain attention's and its logits
   within WHISPER_FP32_LOGIT_LIMIT of them (the kernel fed bf16-rounded q,
   k, v must land beyond it); bf16 logits as close to an fp32 prefill as
   the plain bf16 prefill's;
11. serves full-width, full-depth llava-next-mistral-7b (32 layers, bf16,
   each prompt beginning with 1152 image positions) as ``serve`` serves
   h2o-danube-3-4b (``serve_vlm``): 4 x 2048-token prompts to 32 tokens,
   then 1 x 5120 to 8, 32 flash launches per prefill;
12. trains full-width h2o-danube-3-4b cut to 2 layers through
   ``repro_torch.launch.train`` (batch 2 x 2048 tokens, bf16 parameters,
   fp32 AdamW moments, a corpus and checkpoints on the POSIX Connector in
   a temporary directory): a run stopped by an injected failure at step 5,
   then a restart from the step-4 checkpoint; it checks the loss and
   gradients against plain-attention steps in bf16 and fp32, the kernel
   launches per step and per checkpoint, the restored bytes, the digests
   on disk against numpy, and that a flipped byte fails the restore; the
   restart's save is replicated (``--replicate-to s3``) by a third-party
   ``TransferService`` task to an emulated object store in host memory:
   the task must succeed with integrity on, every leaf's lanesum32 at the
   destination must equal the digest the card took at save time, the
   mirror must restore onto the card byte for byte, and a byte flipped in
   the mirror must fail its restore (``replication`` in ``train``);
13. trains full-width rwkv6-7b cut to 2 layers the same way, without
   checkpoints (``train_rwkv``): 2 scan launches per layer and step (the
   forward, then the block remat's recompute; the backward is the plain
   chunked form's), no flash or checksum launch, one step's per-token
   losses and gradients through the kernel in bf16 and fp32 against the
   plain scan's, the warm training rate and a profiled step's device time
   split into the scan kernel, the plain scan backward, AdamW and the rest;
14. trains full-width, full-depth granite-moe-1b-a400m (uncut: 24 layers,
   1,334,628,352 parameters) the same way (``train_moe``): one fp32 step's
   per-token losses, moe_aux and gradient leaves through the kernel against
   plain attention's within MOE_TRAIN_FP32_LIMIT (the kernel fed
   bf16-rounded q, k, v must land beyond it; routing decisions that differ
   printed), 2 TMA flash launches per layer and step, the warm rate and a
   profiled step split into the flash forward, the attention backward
   (one backward kernel launch a layer and step), MoE dispatch and combine,
   AdamW and the rest; then
   ``remat="dots"`` on the same state and batch (``train_moe_dots``): an
   fp32 loss and gradient against the block remat's within DOTS_FP32_LIMIT,
   the matrix products each backward dispatches, timed steps with 2 TMA
   flash launches per layer, a step's peak above the state beside the
   block steps', and the bytes held from the forward to the backward
   (dots' above block's: the saved products); then it saves the trained parameters with save_checkpoint
   (lanesum32 on the card);
15. serves through the sharding layer (``serve_sharded``): a one-rank NCCL
   group and a (1, 1) ("data", "model") CUDA mesh; granite-moe's trained
   parameters restored from that checkpoint onto the prefill cell's
   placements (digests verified on the card), 4 x 512 prompts and 8 decode
   steps through ``launch.cells.build_cell``'s prefill and decode steps,
   24 flash launches a prefill through ``local_map``, bf16 first tokens and
   fp32 logits (within SHARDED_FP32_LIMIT) against the unsharded run, both
   prefills' walls and idle shares; then jamba scaled down in fp32 the same
   way (the scan and flash's fp32 path through ``local_map``);
16. replicates that checkpoint through the port's federation plane
   (``federate``): a FederatedCoordinator over three TransferManager sites
   sharing one ReplicaCatalog, s0 owning the cluster's POSIX store behind
   a FaultProxyConnector (transient errors on its sends, mid-stream too),
   s1 an emulated s3 store and s2 a gcs store (streams into both cut
   short once or twice a file); two copies submitted as TransferSpec JSON
   (integrity on, lanesum32), s0 failed with both mid-flight and each
   handed to a peer with its restart markers, then a third copy to a second
   path of the s3 store that the catalog must serve from the s3 replica
   without reading the source; every copy SUCCEEDED, faults injected and
   retried, tenant and origin kept across the handoff, the coordinator
   charged no model time, and each of the three replicas restored byte
   for byte, every leaf's lanesum32 taken by the kernel on the card from
   the replica's bytes equal to the save-time digest;
17. runs the sharding layer's CPU cases under this machine's torch
   (``sharded_gloo``: pytest over GLOO_TESTS in two processes, started
   beside the build): 4-rank gloo groups on the CPU, a 2x2 mesh for each
   family (dense, rwkv6, jamba, granite-moe unpinned and under both pins,
   whisper) and the 1x4 and 1x2 meshes, each family's sharded prefill,
   decode and train steps against the unsharded port within 1e-5, no op
   that torch 2.11's DTensor refuses, the dry run's 2x2x2 cells and the
   peak live-bytes tracker; every case must pass.  CPU ranks, not the
   card: NCCL puts no two ranks on one card;
18. runs the port's pod-scale dry run of all 34 single-pod cells on the
   16x16 mesh (``dryrun``: ``python -m repro_torch.launch.dryrun --all
   --single-pod-only`` in its own process, started beside the build, its
   fake process group of 256 ranks kept away from serve_sharded's real
   one): every record ``ok`` with its temp bytes counted; DRYRUN_CELL's
   roofline terms against the H100's datasheet figures, temps,
   ``fits_hbm``, seconds, and its counts over the same cell's CPU reading
   under torch 2.13 (DRYRUN_CPU_READING: DTensor's rules, and so the
   counts, differ between torch versions); then ``perf_iter``:
   ``scripts/perf_iter_torch.py`` on PERF_ITER_CELL under ``remat=dots``
   and ``remat=block`` (started beside the build too), the three terms,
   the full-depth temps and their dots-over-block ratios;
19. counts ``train_moe``'s step on ``meta`` tensors (``roofline``: the
   port's ``cost_numbers`` and peak live bytes for the same config and 2 x
   2048 tokens) and sets its FLOPs and bytes against
   ``roofline.hw.HW_H100`` beside the step seconds and busy ms
   ``train_moe`` measured, and its peak beside the step's measured
   ``torch.cuda.max_memory_allocated``, then the dots step's peak and the
   bytes its forward holds for the backward above block's, each beside the
   card's reading within PEAK_MATCH, and each remat's loss and gradient
   peak the same way; checks that ``HW_H100``'s 80 GB is
   within HBM_MATCH of the card's memory;
20. prints one JSON line of per-kernel launches (by path), times and
   bounds, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero.  Without CUDA, or without the repository
around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

ARCH = "h2o-danube-3-4b"
#: (requests, prompt tokens, generated tokens) served at full width
WORKLOADS = [(4, 512, 32), (1, 5120, 8)]
#: B, Sq, Skv, H, KV, dh, causal, window: tests/test_kernels.py's ATTN_CASES,
#: then the full-width head shape at small lengths and at the two served ones
CHECK_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 128, 128, 4, 4, 128, True, None),
    (1, 96, 96, 8, 1, 32, True, None),
    (2, 64, 256, 4, 4, 48, False, None),
    (1, 256, 256, 4, 2, 64, True, 96),
    (1, 130, 130, 2, 2, 80, True, 64),
    (1, 64, 64, 32, 8, 120, True, 48),
    (2, 300, 300, 32, 8, 120, True, 128),
    (1, 333, 333, 8, 2, 128, True, 200),  # lengths ragged against the 128-row tiles
    (2, 130, 333, 4, 1, 64, False, 100),
    (2, 333, 333, 16, 16, 64, False, None),  # whisper's encoder heads, ragged
    (1, 1500, 1500, 16, 16, 64, False, None),  # ... at its 1500 frames
    (2, 300, 300, 32, 8, 128, True, 128),  # llava's heads
]
#: bf16 inputs a TMA tensor map cannot describe, which take the mma.sync
#: kernel: a head dim of 20 (40-byte rows), and q, k, v whose data start one
#: element (2 bytes) past a 16-byte boundary
SYNC_CASES = [((2, 200, 200, 4, 2, 20, True, None), 0),
              ((1, 300, 300, 32, 8, 120, True, 128), 1)]
MAIN_CASES = [(4, 512, 512, 32, 8, 120, True, 4096),
              (1, 5120, 5120, 32, 8, 120, True, 4096),
              (2, 2048, 2048, 32, 8, 120, True, 4096),  # the training step's
              (4, 512, 512, 16, 8, 64, True, None),  # granite-moe's 4 x 512 prefill
              (4, 1500, 1500, 16, 16, 64, False, None),  # whisper's encoder at 4 requests
              (4, 2048, 2048, 32, 8, 128, True, 4096),  # llava's 4 x 2048 prefill
              (2, 2048, 2048, 16, 8, 64, True, None)]  # granite-moe's training step
#: the backward kernel's main-path shapes: granite-moe's train_4k step (16 /
#: 8 heads of 64, the 64-wide instance) and the dense training step's heads
#: (h2o-danube-3-4b at TRAIN_SEQ, 32 / 8 of 120, the 128-wide one)
BWD_MAIN_CASES = [(2, 4096, 4096, 16, 8, 64, True, None),
                  (2, 2048, 2048, 32, 8, 120, True, 4096)]
#: the backward kernel against the plain backward on bf16 inputs, as
#: tests/test_torch_gpu.py: relative L2 error of each gradient, and the
#: largest error over the largest |plain| (the kernel rounds P and dS to
#: bf16 as operands, the plain backward keeps them fp32)
BWD_REL_L2, BWD_MAX = 1e-2, 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # rtol = atol, as tests/test_kernels.py
#: served logits may be this many times further from an fp32 prefill than
#: the plain-attention bf16 prefill's logits are
LOGIT_SLACK = 1.5
#: rwkv6-7b fp32 prefill, kernel scan against plain scan: largest logit
#: difference allowed.  A sound kernel read 1.66e-4 (fp32 order of sums
#: through 32 layers); the scan fed bf16 q, k, v (ssm_bf16_io) read 0.17 to
#: 0.19 and must stay above it.
FP32_LOGIT_LIMIT = 2e-3

#: calls under the profiler for kernel_times' device time per call, and runs
#: of a profile that lost kernel records before the phase fails
PROFILED_CALLS, PROFILE_TRIES = 20, 5
#: H100 SXM data sheet, dense: memory bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12

#: training: full width, depth cut to TRAIN_LAYERS (checkpoint bytes on disk
#: and the time limit), batch x tokens, injected failure before FAIL_AT
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, FAIL_AT, CKPT_EVERY = 2, 2, 2048, 6, 5, 2
WARM_STEPS = 12  # unprofiled warm steps timed one by one for the training rate
#: the emulated object store the training restart replicates its save to
MIRROR_PROVIDER = "s3"
#: rwkv6 training: full width cut to TRAIN_LAYERS layers, TRAIN_BATCH x
#: TRAIN_SEQ tokens a step, this many steps through run_training
RWKV_TRAIN_STEPS = 3
#: checksum_check cases: tests/test_kernels.py's six shape and dtype pairs
CHECKSUM_CASES = [((1024,), "float32"), ((8, 128), "float32"), ((1000,), "float32"),
                  ((333,), "int32"), ((64, 9), "bfloat16"), ((5,), "float32")]
#: words of the fp32 buffer above 2 GiB
BIG_WORDS = 2**29 + 4099

RWKV_ARCH = "rwkv6-7b"
#: (requests, prompt tokens, generated tokens) served at full width and depth
RWKV_WORKLOADS = [(4, 512, 32), (1, 5120, 8)]
#: B, T, H, K, V, use_u, chunk, subchunk, kind: tests/test_kernels.py's
#: SSM_CASES, its strong-decay case and a scalar decay (g constant over K),
#: then the full-width rwkv6 head shape at a ragged T and at the two served
#: shapes (the served rwkv6 layers call the scan with chunk 128, subchunk 16)
SSM_SMALL_CASES = [
    (2, 64, 3, 8, 16, False, 32, 8, "random"),
    (1, 128, 2, 16, 16, False, 64, 16, "random"),
    (2, 48, 2, 8, 8, True, 16, 8, "random"),
    (1, 40, 4, 8, 8, True, 16, 4, "random"),
    (1, 256, 1, 32, 32, False, 128, 16, "random"),
    (1, 64, 2, 8, 8, True, 32, 8, "strong"),
    (2, 48, 3, 8, 8, False, 16, 8, "scalar"),
]
#: the chunked kernel's edges, fp32 and bf16: T of 1 and 17 (one ragged
#: chunk), a decay of about -20 a step (``harsh``: a factorisation about a
#: sub-chunk's start would overflow there), K = 128 with V = 40 (a ragged
#: 32-column block), K = 18 (rows that cp.async cannot copy whole), and
#: enough heads for 64-column blocks with V = 72 (a ragged one)
SSM_EDGE_CASES = [
    (1, 1, 2, 8, 8, True, 16, 8, "random"),
    (2, 17, 3, 16, 8, False, 16, 8, "random"),
    (2, 70, 2, 64, 64, True, 32, 16, "harsh"),
    (1, 45, 2, 8, 16, False, 16, 8, "harsh"),
    (1, 100, 2, 128, 40, True, 32, 16, "random"),
    (1, 33, 2, 18, 12, True, 16, 4, "random"),
    (3, 40, 48, 16, 72, True, 16, 8, "random"),
]
SSM_WIDE_CASES = [(2, 300, 64, 64, 64, True, 128, 16, "random")]
SSM_MAIN_CASES = [(4, 512, 64, 64, 64, True, 128, 16, "random"),
                  (1, 5120, 64, 64, 64, True, 128, 16, "random")]
#: fp32: rtol = atol as tests/test_kernels.py (3e-5; 1e-4 for strong decay)
SSM_TOL = {"random": 3e-5, "scalar": 3e-5, "strong": 1e-4, "harsh": 3e-5}
#: bf16 y: two bf16 ulps (an ulp is at most 2^-7 of the value), since the
#: kernel and the plain version each round their fp32 y to bf16 once
SSM_BF16_RTOL = 2.0 ** -6
#: H100 SXM data sheet: fp32 FLOP/s on the CUDA cores (no tensor cores)
PEAK_FP32_FLOPS = 67e12

MOE_ARCH = "granite-moe-1b-a400m"
#: (requests, prompt tokens, generated tokens) served at full width and depth
MOE_WORKLOADS = [(4, 512, 32), (1, 5120, 8)]
#: granite-moe fp32 prefill, flash kernel against plain attention: largest
#: logit difference allowed.  A sound kernel read 4.2e-6 / 7.6e-6 at 4 x 512
#: / 1 x 5120 (no routing decision differed); the kernel fed bf16-rounded
#: q, k, v read 0.109 / 0.036 and must stay above it.
MOE_FP32_LOGIT_LIMIT = 1e-3
#: moe_apply's record_function ranges: profiles keep them out of the kernels
MOE_RANGES = ("moe/dispatch", "moe/combine")
#: the ranges a granite-moe training step's profile reads (and keeps out of
#: the kernels)
MOE_STEP_RANGES = ("train_step/loss_and_grad", "train_step/adamw",
                   "flash_attention/plain_backward", *MOE_RANGES)

#: jamba: one mamba mixer at full width, (batch, tokens) of its prefills,
#: then this many one-token decode steps
HYBRID_ARCH = "jamba-1.5-large-398b"
MAMBA_SHAPES = [(4, 512), (1, 5120)]
MAMBA_DECODE_STEPS = 8
#: B, T, H, K, V, use_u, chunk, subchunk, kind: the mamba layer's scan at
#: full width (256 heads, K = V = 64, one decay per head), both shapes
MAMBA_MAIN_CASES = [(4, 512, 256, 64, 64, False, 512, 128, "mamba"),
                    (1, 5120, 256, 64, 64, False, 512, 128, "mamba")]
#: allocator slack per tensor in the copy-free check: a block may hold up to
#: 1 MiB past its 512-byte rounded request (CUDA caching allocator)
ALLOC_SLACK = 2 << 20
#: the scaled-down hybrid stack served in fp32 (requests, prompt, generated)
HYBRID_WORKLOADS = [(2, 256, 8)]
#: its logits, flash and scan kernels against plain attention and the plain
#: scan: largest difference allowed.  A sound pair of kernels read at most
#: 1.02e-5 over the prefill and 7 decode steps; the scan fed bf16 q, k, v
#: (ssm_bf16_io) read 0.048 and must stay above it.
HYBRID_FP32_LOGIT_LIMIT = 1e-3
#: the published Jamba (AI21-Jamba2-Mini, 16 of 32 layers): the benchmark's
#: configuration, its selective scan's lengths at B1, and the prompt it serves
JAMBA2_CONFIG = os.path.join(ROOT, "portbench", "configs", "ai21-jamba2-mini.json")
SCAN1_LENGTHS = (16384, 65536)
JAMBA2_PROMPT = 16384
#: the selective scan against its plain chunked form on the same rounded
#: inputs: bf16 y within SCAN1_Y_TOL (1 + |y|), a bf16 rounding apart; the
#: fp32 state within SCAN1_STATE_TOL (1 + |s|)
SCAN1_Y_TOL, SCAN1_STATE_TOL = 2e-2, 1e-3

WHISPER_ARCH = "whisper-medium"
#: (requests, decoder prompt tokens, generated tokens), each request with
#: n_audio_ctx = 1500 audio frames: batched transcription of 30 s windows
WHISPER_WORKLOADS = [(4, 64, 32), (16, 64, 32)]
#: whisper-medium fp32 prefill, flash kernel against plain attention:
#: largest logit difference allowed.  A sound kernel read 5.2e-6 / 6.3e-6 at
#: 4 / 16 requests on an H100; the kernel fed bf16-rounded q, k, v read
#: 7.0e-3 / 7.2e-3 and must stay above it.
WHISPER_FP32_LOGIT_LIMIT = 1e-3
VLM_ARCH = "llava-next-mistral-7b"
#: (requests, prompt tokens, generated tokens), each prompt beginning with
#: n_image_tokens = 1152 image positions: a chat request with one anyres image
LLAVA_WORKLOADS = [(4, 2048, 32), (1, 5120, 8)]
#: MoE training: granite-moe-1b-a400m uncut, TRAIN_BATCH x TRAIN_SEQ tokens a
#: step, this many steps through run_training, then warm steps timed
MOE_TRAIN_STEPS, MOE_WARM_STEPS = 3, 5
#: granite-moe fp32 training step, flash kernel against plain attention: the
#: largest per-token loss and moe_aux difference and the largest gradient
#: leaf's relative L2 error allowed.  Set before the first run from serving's
#: readings (fp32 logits 4.2e-6 / 7.6e-6 from plain attention's, the
#: bf16-input kernel's 0.036-0.109); the kernel fed bf16-rounded q, k, v
#: must land beyond it on the per-token losses.
MOE_TRAIN_FP32_LIMIT = 1e-3
#: the sharded serving run: (requests, prompt tokens, decode steps), and the
#: largest fp32 logit difference allowed against the unsharded prefill (one
#: rank: every placement is trivial, so the runs should be bit-equal)
SHARDED_WORKLOAD = (4, 512, 8)
SHARDED_FP32_LIMIT = 1e-6
#: the federated replication of train_moe's checkpoint: the site that owns
#: each emulated store (s0 owns the cluster's POSIX store), the tenant the
#: copies run for, the bytes the source streams before it holds for the site
#: failure, the fault schedules' seed, and the wall limit of each wait, seconds
FED_STORES = {"s1": "s3", "s2": "gcs"}
FED_TENANT = "trainer"
FED_HOLD_BYTES = 256 << 20
FED_SEED = 23
FED_TIMEOUT = 300.0
#: the dry run's cell whose counts are printed (single pod, 16x16), and the
#: time limit of the dry run of all 34 single-pod cells, seconds
DRYRUN_CELL, DRYRUN_TIMEOUT = (MOE_ARCH, "train_4k"), 900
#: the sharding layer's CPU cases (no JAX), in groups that run as pytest
#: processes side by side, and their time limit, seconds
GLOO_TESTS = (("tests/test_torch_cells.py",),
              ("tests/test_torch_dryrun.py", "tests/test_torch_memory.py"))
GLOO_TIMEOUT = 900
#: the counted peak live bytes of train_moe's step against the measured peak:
#: the widest ratio allowed either way (a tracker that lost or double-counted
#: storages would land far outside it)
PEAK_MATCH = 2.0
#: the same cell's counts a rank on a CPU under torch 2.13.0+cpu (PERF.md's
#: dry-run table): the phase prints this run's counts over these, as DTensor's
#: sharding rules, and so the counts, differ between torch versions
DRYRUN_CPU_READING = {"torch": "2.13.0+cpu", "hlo_flops_per_dev": 24449503985664.0,
                      "hlo_bytes_per_dev": 5380849556342.0,
                      "coll_bytes_per_dev": 291556388996.0,
                      "bytes_per_dev_temp": 45772304408.0}
#: HW_H100's HBM bytes against the card's total memory: largest relative gap
HBM_MATCH = 0.03
#: remat="dots" on train_moe's step in fp32: loss (relative) and each gradient
#: leaf (relative L2) against the block remat's.  A remat recomputes the same
#: ops; MoE's index backward adds with atomics, whose order may change the
#: fp32 sums by about 1e-7 of their size (the block step run twice is printed
#: beside it; on an H100 both differences read 0)
DOTS_FP32_LIMIT = 1e-5
#: scripts/perf_iter_torch.py's cell and remat settings (each a --set), and
#: the time limit of both counts, seconds
PERF_ITER_CELL, PERF_ITER_REMATS, PERF_ITER_TIMEOUT = (MOE_ARCH, "train_4k"), ("dots", "block"), 900


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def attention_work(B, Sq, Skv, H, KV, dh, causal, window, elem_bytes):
    """(bytes, flops) the attention forward must move and do: q, k, v read
    once, o written once; 4 * dh flops per unmasked (q, k) pair."""
    pairs = 0
    for q in range(Sq):
        lo = max(0, q - window + 1) if window is not None else 0
        hi = min(Skv, q + 1) if causal else Skv
        pairs += max(0, hi - lo)
    nbytes = elem_bytes * dh * (2 * B * Sq * H + 2 * B * Skv * KV)
    return nbytes, 4 * dh * pairs * B * H


def time_ms(fn, torch, min_s=0.2):
    """Mean device time of one call, by CUDA events over a run of calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = max(3, min(200, int(min_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def attn_inputs(case, dtype, seed, device, torch, offset=0):
    """q, k, v of ``case``; with ``offset``, each a view that starts that many
    elements into its buffer."""
    B, Sq, Skv, H, KV, dh, _, _ = case
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(math.prod(shape) + offset, generator=gen, device=device).to(dtype)
            [offset:].view(shape)
            for shape in ((B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh))]


def flash_counts(fa_kernel):
    """The flash wrapper's launch counts: (all, TMA, mma.sync, fp32)."""
    return (fa_kernel.launches, fa_kernel.tma_launches, fa_kernel.sync_launches,
            fa_kernel.f32_launches)


def reset_flash_counts(fa_kernel):
    fa_kernel.launches = fa_kernel.tma_launches = 0
    fa_kernel.sync_launches = fa_kernel.f32_launches = 0


def kernel_check(torch, fa_kernel, fa_ref, device):
    """Kernel against the plain chunked version and attention_ref on the card.

    The limit is ``atol + rtol * |want|`` with rtol = TOL.  On CHECK_CASES
    atol = TOL too, as in tests/test_kernels.py.  On MAIN_CASES a row mixes
    up to 4096 keys, so its outputs are about 0.03 and an atol of 2e-2
    would hide a fault: there atol is TOL times the mean |want| of each
    (b, q, h) row, the scale of that row's outputs and of its rounding."""
    rows, worst = [], 0.0
    cases = [(c, dt, 0) for c in CHECK_CASES for dt in ("float32", "bfloat16")]
    cases += [(c, "bfloat16", 0) for c in MAIN_CASES]
    cases += [(c, "bfloat16", off) for c, off in SYNC_CASES]
    for i, (case, dt, off) in enumerate(cases):
        *_, causal, window = case
        q, k, v = attn_inputs(case, getattr(torch, dt), i, device, torch, offset=off)
        want_path = ("fp32" if dt == "float32" else
                     "TMA" if (case[5] % 8 == 0 and not off) else "mma.sync")
        check((want_path == "TMA") == fa_kernel.tma_path(q, k, v),
              f"case {case} {dt} offset {off}: tma_path disagrees with {want_path}")
        counts = flash_counts(fa_kernel)
        got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window).float()
        torch.cuda.synchronize()
        took = tuple(a - b for a, b in zip(flash_counts(fa_kernel), counts))
        want = {"TMA": (1, 1, 0, 0), "mma.sync": (1, 0, 1, 0), "fp32": (1, 0, 0, 1)}[want_path]
        check(took == want, f"case {case} {dt}: launches (all, TMA, mma.sync, fp32) {took}, "
                            f"want one on the {want_path} path")
        row = {"case": list(case), "dtype": dt, "offset_elems": off, "path": want_path}
        for name, want in (
                ("plain", fa_ref.chunked_attention(q, k, v, causal=causal, window=window,
                                                   chunk=128)),
                ("attention_ref", fa_ref.attention_ref(q, k, v, causal=causal, window=window))):
            want = want.float()
            err = (got - want).abs()
            atol = (TOL[dt] * want.abs().mean(dim=-1, keepdim=True) if case in MAIN_CASES
                    else torch.full_like(want[..., :1], TOL[dt]))
            share = err / (atol + TOL[dt] * want.abs())
            at = share.argmax()
            row.update({f"max_abs_err_{name}": err.max().item(),
                        f"min_atol_{name}": atol.min().item(),
                        f"max_err_share_of_limit_{name}": share.flatten()[at].item(),
                        f"err_at_worst_share_{name}": err.flatten()[at].item()})
            check(row[f"max_err_share_of_limit_{name}"] <= 1.0,
                  f"kernel vs {name}: case {case} {dt}: {row}")
            del want, err, atol, share
        worst = max(worst, row["max_abs_err_plain"])
        rows.append(row)
    acc_rows, acc_worst = accum_check(torch, fa_kernel, fa_ref, device)
    bwd_rows, bwd_worst = backward_check(torch, fa_kernel, device)
    emit({"phase": "kernel_check", "ok": True, "cases": rows, "accum_bf16_cases": acc_rows,
          "backward_cases": bwd_rows})
    return max(worst, acc_worst), bwd_worst


def backward_inputs(case, seed, device, torch):
    """q, k, v of ``case`` in bf16 and the output's gradient do."""
    B, Sq, _, H, _, dh, _, _ = case
    q, k, v = attn_inputs(case, torch.bfloat16, seed, device, torch)
    gen = torch.Generator(device).manual_seed(seed + 1)
    return q, k, v, torch.randn(B, Sq, H, dh, generator=gen, device=device).bfloat16()


def backward_check(torch, fa_kernel, device):
    """The backward kernel on BWD_MAIN_CASES: a gradient through
    ``FlashAttention`` launches the LSE forward and the backward kernel once
    each, and its dq, dk and dv are within BWD_REL_L2 (relative L2) and
    BWD_MAX (of the largest |plain|) of the plain backward's on the same
    inputs.  Returns (rows, the largest absolute error)."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention, plain_backward
    rows, worst = [], 0.0
    for i, case in enumerate(BWD_MAIN_CASES):
        *_, causal, window = case
        chunk = min(1024, case[2])
        q, k, v, do = backward_inputs(case, 200 + i, device, torch)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        counts, bwd_before = flash_counts(fa_kernel), fa_kernel.bwd_launches
        got = torch.autograd.grad(FlashAttention.apply(*leaves, causal, window, chunk),
                                  leaves, do)
        torch.cuda.synchronize()
        took = tuple(a - b for a, b in zip(flash_counts(fa_kernel), counts))
        bwd = fa_kernel.bwd_launches - bwd_before
        check(took == (1, 1, 0, 0) and bwd == 1,
              f"backward case {case}: launches (all, TMA, mma.sync, fp32) {took} and "
              f"{bwd} of the backward kernel, want one each")
        want = plain_backward(q, k, v, do, causal=causal, window=window, chunk=chunk)
        row = {"case": list(case), "backward_kernel_launches": bwd}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            err = (g - w).abs().max().item()
            row[name] = {"rel_l2": ((g - w).norm() / w.norm()).item(), "max_abs_err": err,
                         "max_err_over_max_plain": err / w.abs().max().item()}
            check(row[name]["rel_l2"] <= BWD_REL_L2 and row[name]["max_err_over_max_plain"]
                  <= BWD_MAX, f"backward kernel vs the plain backward: {name}: {row}")
            worst = max(worst, err)
        rows.append(row)
        del q, k, v, do, leaves, got, want
    return rows, worst


def accum_check(torch, fa_kernel, fa_ref, device):
    """The kernels' attn_accum_bf16 mode on ``fa_kernel.ACC_CASES``, bf16
    inputs (the mma.sync kernel) and fp32 ones (the fp32 kernel): against
    the plain chunked form with ``accum_bf16`` element by element
    (ACC_TOL), and against fp32 truth by the mean error (ACC_MEAN_RATIO),
    where the fp32-accumulating kernel on the same inputs must fail the
    latter.
    Returns (rows, the largest absolute error against the plain form)."""
    ACC_TOL, ACC_MEAN_RATIO = fa_kernel.ACC_TOL, fa_kernel.ACC_MEAN_RATIO
    rows, worst = [], 0.0
    for i, (case, chunk) in enumerate(fa_kernel.ACC_CASES):
        *_, causal, window = case
        for dt in ("bfloat16", "float32"):
            q, k, v = attn_inputs(case, getattr(torch, dt), 300 + i, device, torch)
            path = "mma.sync" if dt == "bfloat16" else "fp32"
            counts = flash_counts(fa_kernel)
            got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                                accum_chunk=chunk).float()
            torch.cuda.synchronize()
            took = tuple(a - b for a, b in zip(flash_counts(fa_kernel), counts))
            want = {"mma.sync": (1, 0, 1, 0), "fp32": (1, 0, 0, 1)}[path]
            check(took == want, f"accum_bf16 case {case} {dt}: launches (all, TMA, mma.sync, "
                                f"fp32) {took}, want one on the {path} path")
            plain = fa_ref.chunked_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                                             accum_bf16=True).float()
            truth = fa_ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                         window=window)
            f32_acc = fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                                    window=window).float()
            scale = truth.abs().mean(dim=-1, keepdim=True).clamp(min=1e-30)
            err = (got - plain).abs()
            share = err / (ACC_TOL * (plain.abs() + plain.abs().mean(dim=-1, keepdim=True)))
            mean_err = lambda o: ((o - truth).abs() / scale).mean().item()
            m_plain = mean_err(plain)
            row = {"case": list(case), "accum_chunk": chunk, "dtype": dt, "path": path,
                   "max_abs_err_plain": err.max().item(),
                   "max_err_share_of_limit_plain": share.max().item(),
                   "mean_err_vs_fp32_plain": m_plain,
                   "mean_err_ratio_vs_fp32": mean_err(got) / m_plain,
                   "fp32_accumulating_mean_err_ratio": mean_err(f32_acc) / m_plain}
            rows.append(row)
            worst = max(worst, row["max_abs_err_plain"])
            check(row["max_err_share_of_limit_plain"] <= 1.0,
                  f"accum_bf16 kernel vs the plain form: {row}")
            band = lambda r: 1 / ACC_MEAN_RATIO <= r <= ACC_MEAN_RATIO
            check(band(row["mean_err_ratio_vs_fp32"]),
                  f"accum_bf16 kernel's error against fp32 is not the plain form's: {row}")
            check(not band(row["fp32_accumulating_mean_err_ratio"]),
                  f"the fp32-accumulating kernel lands inside ACC_MEAN_RATIO: the check "
                  f"tells nothing apart: {row}")
            del q, k, v, got, plain, truth, f32_acc, scale, err, share
    return rows, worst


def kernel_times(torch, fa_kernel, fa_ref, F, device):
    """kernel / plain / library times and the bound at the main-path shapes:
    CUDA-event times over a loop of calls, and the device time per call that
    torch.profiler records over PROFILED_CALLS calls, kernel and library
    alike.  The library call is SDPA with ``is_causal`` where the window does
    not cut, else with the causal-and-window band as a boolean mask, which
    takes SDPA off its flash backend; there SDPA with ``is_causal`` (every
    causal pair, a superset of the band) is timed too, as the yardstick a
    user would pick."""
    out = []
    for i, case in enumerate(MAIN_CASES):
        B, Sq, Skv, H, KV, dh, causal, window = case
        q, k, v = attn_inputs(case, torch.bfloat16, 100 + i, device, torch)
        nbytes, flops = attention_work(*case, elem_bytes=2)
        t_mem, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        row = {"B": B, "S": Sq, "H": H, "KV": KV, "dh": dh, "window": window,
               "bytes": nbytes, "flops": flops,
               "ms": time_ms(lambda: fa_kernel.flash_attention_fwd(
                   q, k, v, causal=causal, window=window), torch),
               "plain_ms": time_ms(lambda: fa_ref.chunked_attention(
                   q, k, v, causal=causal, window=window, chunk=1024), torch),
               "bound_ms": max(t_mem, t_ops),
               "bound_by": "bytes" if t_mem >= t_ops else "operations"}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None or window >= Skv:  # SDPA's causal mask is the same mask
            sdpa = dict(is_causal=causal)
        else:
            pos = torch.arange(Sq, device=device)
            sdpa = dict(attn_mask=(pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - window))

        def lib(**kw):
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **(kw or sdpa))

        row["library_ms"] = time_ms(lib, torch)
        # attn_accum_bf16 at the model's chunk (the mma.sync kernel's
        # bf16-accumulating instance) and its plain chunked form
        acc_chunk = min(1024, Skv)
        acc = lambda: fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                                    accum_chunk=acc_chunk)
        row["accum_bf16_chunk"] = acc_chunk
        row["accum_bf16_ms"] = time_ms(acc, torch)
        row["accum_bf16_plain_ms"] = time_ms(lambda: fa_ref.chunked_attention(
            q, k, v, causal=causal, window=window, chunk=acc_chunk, accum_bf16=True), torch)
        row["library_max_abs_err"] = (lib().transpose(1, 2).float() - fa_ref.chunked_attention(
            q, k, v, causal=causal, window=window).float()).abs().max().item()
        row["kernel_ms"] = row["ms"]
        # device time per call from the profiler's kernel records, which an
        # enqueue-bound loop of events would not show
        timed = [("device_ms", lambda: fa_kernel.flash_attention_fwd(
            q, k, v, causal=causal, window=window)), ("library_device_ms", lib),
                 ("accum_bf16_device_ms", acc)]
        if "attn_mask" in sdpa:
            causal_lib = lambda: lib(is_causal=True)
            row["library_is_causal_ms"] = time_ms(causal_lib, torch)
            timed.append(("library_is_causal_device_ms", causal_lib))
        for key, fn in timed:
            kernels, n, *_ = profile_device(
                torch, lambda: [fn() for _ in range(PROFILED_CALLS)],
                complete=lambda counts: counts and all(
                    c % PROFILED_CALLS == 0 for c in counts.values()))
            row[key] = sum(kernels.values()) / PROFILED_CALLS
            row[key.replace("_ms", "_kernels_per_call")] = n / PROFILED_CALLS
        row["ratio_to_library"] = row["ms"] / row["library_ms"]
        row["device_ratio_to_library"] = row["device_ms"] / row["library_device_ms"]
        if "attn_mask" in sdpa:
            row["device_ratio_to_library_is_causal"] = (row["device_ms"]
                                                        / row["library_is_causal_device_ms"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
        row["accum_bf16_device_share_of_bound"] = row["bound_ms"] / row["accum_bf16_device_ms"]
        row["accum_bf16_device_ratio_to_kernel"] = (row["accum_bf16_device_ms"]
                                                    / row["device_ms"])
        out.append(row)
        del q, k, v, qt, kt, vt, sdpa, acc
    emit({"phase": "kernel_times", "rows": out})
    return out


def backward_times(torch, fa_kernel, device):
    """The backward kernel at BWD_MAIN_CASES, as ``kernel_times`` times the
    forward: CUDA-event ms and the profiler's device ms per call of its
    three kernels (prep, main, dQ pass; each apart too), the plain backward
    (its oracle) and SDPA's backward (``is_causal``, the library's; the
    port never calls it).  The bound is the forward's at 2.5x its FLOPs (5
    products of 2 dh a pair, not 2) and 2x its bytes (q, k, v, o, dO read;
    dq, dk, dv written; lse, D and the fp32 dQ accumulator besides), as
    portbench/metrics/flash_bwd_roofline.train.py counts it."""
    from repro_torch.kernels.flash_attention.ops import plain_backward
    out = []
    for i, case in enumerate(BWD_MAIN_CASES):
        B, Sq, Skv, H, KV, dh, causal, window = case
        q, k, v, do = backward_inputs(case, 210 + i, device, torch)
        o, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                               with_lse=True)
        fwd_bytes, fwd_flops = attention_work(*case, elem_bytes=2)
        nbytes, flops = 2 * fwd_bytes, 2.5 * fwd_flops
        t_mem, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        kern = lambda: fa_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                                     window=window)
        check(window is None or window >= Skv, f"SDPA's is_causal is not the band of {case}")
        qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                              enable_gqa=True)
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
        row = {"B": B, "S": Sq, "H": H, "KV": KV, "dh": dh, "window": window,
               "bytes": nbytes, "flops": flops, "ms": time_ms(kern, torch),
               "plain_ms": time_ms(lambda: plain_backward(q, k, v, do, causal=causal,
                                                          window=window,
                                                          chunk=min(1024, Skv)), torch),
               "bound_ms": max(t_mem, t_ops),
               "bound_by": "bytes" if t_mem >= t_ops else "operations",
               "library_ms": time_ms(lib, torch)}
        row["kernel_ms"] = row["ms"]
        for key, fn in (("device_ms", kern), ("library_device_ms", lib)):
            kernels, n, *_ = profile_device(
                torch, lambda: [fn() for _ in range(PROFILED_CALLS)],
                complete=lambda counts: counts and all(
                    c % PROFILED_CALLS == 0 for c in counts.values()))
            row[key] = sum(kernels.values()) / PROFILED_CALLS
            row[key.replace("_ms", "_kernels_per_call")] = n / PROFILED_CALLS
            if key == "device_ms":
                check(all("attn_bwd_" in name for name in kernels),
                      f"backward kernels: {sorted(kernels)}")
                row["device_ms_by_kernel"] = {name[:80]: ms / PROFILED_CALLS
                                              for name, ms in kernels.items()}
        row["plain_over_kernel"] = row["plain_ms"] / row["ms"]
        row["ratio_to_library"] = row["ms"] / row["library_ms"]
        row["device_ratio_to_library"] = row["device_ms"] / row["library_device_ms"]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
        out.append(row)
        del q, k, v, do, o, lse, qt, kt, vt, ot, dot
    emit({"phase": "backward_times", "rows": out})
    return out


def serve_full_width(torch, serve, build, fa_kernel, cs_kernel, ssm_kernel, device,
                     arch=ARCH, workloads=WORKLOADS, phase="serve", accum=False):
    """The serving path: full-width serving of ``arch`` through
    repro_torch.launch.serve (h2o-danube-3-4b in ``serve``, llava with its
    image positions in ``serve_vlm``); with ``accum``, the first workload's
    prefill again with ``attn_accum_bf16`` (``accum_bf16_prefill``).
    Returns (rows, flash launches, mma.sync launches, the accum_bf16
    prefill's row or None)."""
    from repro_torch.models.convert import flatten
    results, launches, accum_row = [], 0, None
    for B, S, gen_len in workloads:
        args = serve.parse_args(["--arch", arch, "--no-scaled-down", "--requests", str(B),
                                 "--prompt-len", str(S), "--gen-len", str(gen_len),
                                 "--device", str(device), "--seed", "0"])
        api, params, batch = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(arch), f"not the full-width config: {cfg}")
        leaves = flatten(params).values()
        n_params = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        serve.serve(api, params, batch, 2)  # warm-up: first-call set-up is not timed
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, batch, gen_len)
        n, n_tma, n_sync, n_f32 = flash_counts(fa_kernel)
        launches += n
        check(n == cfg.n_layers, f"{n} kernel launches in one prefill, want {cfg.n_layers}")
        check(n_tma == n, f"serving took the mma.sync path {n_sync} / the fp32 path "
                          f"{n_f32} times")
        check(cs_kernel.launches == 0, "serving launched the checksum kernel")
        check(ssm_kernel.launches == 0, "dense serving launched the scan kernel")
        logits = res["logits"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        toks = res["tokens"]
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        # one profiled prefill: device busy time and the flash kernel's share
        def prefill():
            return api.prefill(params, batch)

        with torch.inference_mode():
            reset_flash_counts(fa_kernel)
            pre_wall = statistics.median(wall_ms(torch, prefill, 3))
            pre_all, pre_tma, pre_sync, _ = flash_counts(fa_kernel)  # 3 prefills
            by_name, pre_n, *_, pre_union, pre_pwall = profile_device(
                torch, prefill, complete=lambda counts: sum(
                    c for name, c in counts.items() if "attn_fwd_bf16_tma" in name) == cfg.n_layers)
        check(pre_all == pre_tma == 3 * cfg.n_layers and pre_sync == 0,
              f"3 prefills: {pre_all} launches, {pre_tma} TMA and {pre_sync} mma.sync, "
              f"want {3 * cfg.n_layers} on the TMA path")
        pre_busy = sum(by_name.values())
        pre_fa = sum(ms for name, ms in by_name.items() if "attn_fwd_bf16_tma" in name)
        check(pre_fa > 0, "the profiled prefill shows no attn_fwd_bf16_tma kernel")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

        # the same prefill through plain attention, in bf16 and in fp32
        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        exact = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"),
                      device)
        before = flash_counts(fa_kernel)
        with torch.inference_mode():
            logits_plain, _, _ = plain.prefill(params, batch)
            logits_exact, _, _ = exact.prefill(params, batch)
        check(flash_counts(fa_kernel) == before,
              f"the plain-attention prefills launched the kernel: (all, TMA, mma.sync, fp32) "
              f"{before} -> {flash_counts(fa_kernel)}")
        diff = (logits - logits_plain).abs().max().item()
        err = (logits - logits_exact).abs().max().item()
        err_plain = (logits_plain - logits_exact).abs().max().item()
        first, first_plain = logits[:, -1].argmax(-1), logits_plain[:, -1].argmax(-1)
        top2 = logits_plain[:, -1].topk(2, dim=-1).values
        row = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
               "params": n_params, "param_bytes": n_bytes,
               "image_positions": cfg.vlm.n_image_tokens if cfg.vlm is not None else 0,
               "requests": B, "prompt_len": S, "gen_len": gen_len,
               "kernel_launches": n, "flash_mma_sync_launches": n_sync + pre_sync,
               "prefill_s": res["prefill_s"],
               "decode_s": res["decode_s"], "prefill_tok_s": res["prefill_tok_s"],
               "decode_tok_s": res["decode_tok_s"], "max_memory_allocated": peak_mem,
               "prefill_profile": {"wall_ms_unprofiled": pre_wall, "device_busy_ms": pre_busy,
                                   **idle_of(pre_union, pre_pwall), "kernels": pre_n,
                                   "flash_kernel_ms": pre_fa,
                                   "flash_kernel_share_of_busy": pre_fa / pre_busy,
                                   "flash_tma_launches": pre_tma // 3,
                                   "flash_mma_sync_launches": pre_sync // 3,
                                   "top_kernels_ms": {k[:80]: v for k, v in top}},
               "max_abs_logit_diff_vs_plain": diff,
               "max_abs_logit_err_vs_fp32": err,
               "plain_max_abs_logit_err_vs_fp32": err_plain,
               "logit_err_ratio": err / err_plain,
               "min_top2_margin_plain": (top2[:, 0] - top2[:, 1]).min().item(),
               "first_tokens": first.tolist(), "sample_tokens": toks[0, :8].tolist()}
        emit({"phase": phase, **row})
        check(bool((first == first_plain).all()),
              f"greedy first token {first.tolist()} vs plain {first_plain.tolist()}")
        # the kernel path may be no further from the fp32 prefill than the plain
        # bf16 one is, with LOGIT_SLACK for the spread of a maximum over logits
        check(err <= LOGIT_SLACK * err_plain,
              f"logits {err} from the fp32 prefill; the plain bf16 one is {err_plain}")
        results.append(row)
        if accum and accum_row is None:
            accum_row = accum_bf16_prefill(torch, build, fa_kernel, cfg, params, batch,
                                           logits_exact, pre_wall, device)
        del api, params, batch, res, logits, logits_plain, logits_exact, plain, exact, prefill
        del leaves
        torch.cuda.empty_cache()
    return (results, launches, sum(r["flash_mma_sync_launches"] for r in results),
            accum_row)


@contextlib.contextmanager
def plain_attention_dispatch():
    """The flash dispatcher sends CUDA tensors to the plain chunked form,
    with the call's chunk and ``accum_bf16``, instead of the kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    dispatch = fa_ops._dispatch
    fa_ops._dispatch = lambda q, k, v, *, causal, window, chunk, accum_bf16=False: \
        chunked_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                          accum_bf16=accum_bf16)
    try:
        yield
    finally:
        fa_ops._dispatch = dispatch


def accum_bf16_prefill(torch, build, fa_kernel, cfg, params, batch, logits_exact, tma_wall,
                       device):
    """The served model's prefill with ``attn_accum_bf16``: through the
    kernel (the mma.sync kernel's bf16-accumulating instance, one launch a
    layer), then through the plain chunked form with ``accum_bf16``: the
    kernel's logits are within LOGIT_SLACK times the plain form's error
    against the fp32 prefill of the plain form's logits, and their own
    error against the fp32 prefill is the plain form's within LOGIT_SLACK
    either way.  Walls beside the fp32-accumulating TMA prefill's
    (``tma_wall``, ms)."""
    api = build(dataclasses.replace(cfg, attn_accum_bf16=True), device)

    def prefill():
        return api.prefill(params, batch)

    with torch.inference_mode():
        prefill()  # warm-up
        reset_flash_counts(fa_kernel)
        logits, _, _ = prefill()
        torch.cuda.synchronize()
        counts = flash_counts(fa_kernel)
        wall = statistics.median(wall_ms(torch, prefill, 3))
        with plain_attention_dispatch():
            before = flash_counts(fa_kernel)
            logits_plain, _, _ = prefill()
            plain_wall = statistics.median(wall_ms(torch, prefill, 3))
            check(flash_counts(fa_kernel) == before,
                  "the plain accum_bf16 prefill launched the kernel")
    check(counts == (cfg.n_layers, 0, cfg.n_layers, 0),
          f"accum_bf16 prefill: launches (all, TMA, mma.sync, fp32) {counts}, want "
          f"{cfg.n_layers} on the mma.sync path")
    check(bool(torch.isfinite(logits).all()), "non-finite accum_bf16 prefill logits")
    err = (logits - logits_exact).abs().max().item()
    err_plain = (logits_plain - logits_exact).abs().max().item()
    B, S = batch["tokens"].shape
    row = {"arch": ARCH, "requests": B, "prompt_len": S,
           "attn_chunk": min(cfg.attn_chunk, S), "flash_launches": counts[0],
           "flash_mma_sync_launches": counts[2], "flash_fp32_launches": counts[3],
           "max_abs_logit_diff_vs_plain": (logits - logits_plain).abs().max().item(),
           "max_abs_logit_err_vs_fp32": err, "plain_max_abs_logit_err_vs_fp32": err_plain,
           "logit_err_ratio": err / err_plain, "wall_ms": wall, "plain_wall_ms": plain_wall,
           "tma_fp32_accumulating_wall_ms": tma_wall}
    emit({"phase": "serve_accum_bf16", **row})
    check(row["max_abs_logit_diff_vs_plain"] <= LOGIT_SLACK * err_plain,
          f"accum_bf16 logits {row['max_abs_logit_diff_vs_plain']} from the plain accum_bf16 "
          f"prefill's; that one is {err_plain} from the fp32 prefill")
    check(1 / LOGIT_SLACK <= err / err_plain <= LOGIT_SLACK,
          f"accum_bf16 logits {err} from the fp32 prefill; the plain accum_bf16 one is "
          f"{err_plain}")
    return row


def checksum_inputs(torch, device):
    """(name, tensor) pairs of checksum_check, all on the card."""
    gen = torch.Generator(device).manual_seed(7)
    out = []
    for shape, dt in CHECKSUM_CASES:
        if dt == "int32":
            x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=device,
                              dtype=torch.int32)
        else:
            x = torch.randn(shape, generator=gen, device=device).to(getattr(torch, dt))
        out.append((f"{dt}{list(shape)}", x))
    b8 = torch.randint(0, 256, (4099,), generator=gen, device=device, dtype=torch.uint8)
    out += [(f"uint8[{n}]", b8[:n]) for n in (1, 2, 3, 5, 7)]
    f32 = torch.randn(4099, generator=gen, device=device)
    bf = f32.to(torch.bfloat16)
    out += [("bfloat16[1001]", bf[:1001]),
            ("int32 0-d", torch.tensor(-123456789, dtype=torch.int32, device=device)),
            ("float32[37,53].T", f32[:37 * 53].reshape(37, 53).T),
            ("bfloat16[3:1004] (offset 6 bytes)", bf[3:1004]),
            ("uint8[1:1002] (offset 1 byte)", b8[1:1002]),
            ("float32[1:1001] (offset 4 bytes)", f32[1:1001])]
    return out


def checksum_check(torch, cs_ops, cs_ref, device):
    """The kernel against its plain PyTorch version and the numpy
    digest_ref, bit-exact, and a flipped bit against the kernel."""
    rows = []

    def one(name, x):
        got = cs_ops.checksum_digest(x)
        plain = cs_ref.digest_of(*cs_ref.lanesum32_torch(x))
        host = x.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
        numpy = cs_ref.digest_ref(host.data)
        rows.append({"case": name, "nbytes": host.size, "kernel": got, "plain": plain,
                     "digest_ref": numpy,
                     "max_abs_word_diff": max(abs(int(got[i:i + 8], 16) - int(plain[i:i + 8], 16))
                                              for i in (0, 8))})
        check(got == plain == numpy, f"checksum {name}: kernel {got}, plain {plain}, "
                                     f"digest_ref {numpy}")
        return got

    for name, x in checksum_inputs(torch, device):
        one(name, x)
    # one fp32 buffer above 2 GiB, then one bit flipped in its last words,
    # above byte 2^31
    big = torch.randn(BIG_WORDS, generator=torch.Generator(device).manual_seed(8),
                      device=device)
    d0 = one(f"float32[{BIG_WORDS}] ({BIG_WORDS * 4} bytes)", big)
    word = BIG_WORDS - 1000
    big.view(torch.int32)[word] ^= 1 << 3
    d1 = one(f"float32[{BIG_WORDS}], bit 3 of byte {word * 4} flipped", big)
    check(d1 != d0, "a flipped bit above 2 GiB left the digest unchanged")
    small = torch.randn(4096, generator=torch.Generator(device).manual_seed(9), device=device)
    d2 = cs_ops.checksum_digest(small)
    small.view(torch.int32)[1234 // 4] ^= 1
    check(cs_ops.checksum_digest(small) != d2, "a flipped bit left the digest unchanged")
    torch.cuda.synchronize()
    emit({"phase": "checksum_check", "ok": True, "cases": rows})
    del big
    torch.cuda.empty_cache()
    return max(r["max_abs_word_diff"] for r in rows)


def checksum_times(torch, cs_kernel, cs_ref, device, largest_leaf):
    """Kernel / plain times and the byte bound for the largest leaf of the
    training state and a 1 GiB buffer.  No single PyTorch call computes
    lanesum32, so there is no library time.  For the largest leaf, also the
    host time of numpy ``digest_ref`` over its bytes, the reference's way
    to digest a checkpoint leaf (on this machine's CPU, one run)."""
    out = []
    gen = torch.Generator(device).manual_seed(10)
    for i, (name, shape, dt) in enumerate((largest_leaf, ("1 GiB", (2**28,), torch.float32))):
        x = torch.randn(shape, generator=gen, device=device).to(dt)
        acc = torch.zeros(2, dtype=torch.int32, device=device)
        nbytes = x.numel() * x.element_size()
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        ms = time_ms(lambda: cs_kernel.lanesum32_into(x, acc), torch)
        out.append({"buffer": name, "shape": list(shape), "dtype": str(dt), "bytes": nbytes,
                    "ms": ms, "kernel_ms": ms,
                    "plain_ms": time_ms(lambda: cs_ref.lanesum32_torch(x), torch),
                    "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                    "share_of_bound": bound / ms})
        if i == 0:
            host = x.reshape(-1).view(torch.uint8).cpu().numpy()
            t0 = time.perf_counter()
            cs_ref.digest_ref(host.data)
            out[-1]["host_digest_ref_ms"] = (time.perf_counter() - t0) * 1e3
        del x
    emit({"phase": "checksum_times", "rows": out})
    return out


def ssm_inputs(case, dtype, seed, device, torch):
    """q, k, v in ``dtype``; g, s0, u fp32; distributed as tests/test_kernels.py's
    ``_ssm_inputs`` draws them (``strong``: log decays about -4.5 a step;
    ``harsh``: about -20 a step; ``scalar``: one log decay per (b, t, h),
    broadcast over K)."""
    B, T, H, K, V, use_u, _, _, kind = case
    gen = torch.Generator(device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = randn(B, T, H, K) * 0.5, randn(B, T, H, K) * 0.5, randn(B, T, H, V) * 0.5
    shift = {"strong": -1.5, "harsh": -3.0}.get(kind, 1.5)
    g = -torch.exp(randn(B, T, H, 1 if kind == "scalar" else K) - shift).expand(B, T, H, K)
    s0, u = randn(B, H, K, V) * 0.3, randn(H, K) * 0.5
    return q.to(dtype), k.to(dtype), v.to(dtype), g, s0, (u if use_u else None)


def scan_errors(torch, y, s_fin, want_y, want_s, dt, tol, name, row, held=True, what=""):
    """The scan's y and final state against ``want``: the largest absolute
    error and share of the limit ``atol + rtol * |want|`` of each go into
    ``row``; with ``held``, a share above 1 fails.  fp32 and the state:
    rtol = atol = ``tol``; bf16 y: rtol SSM_BF16_RTOL and an atol of 3e-5
    times the mean |want| of each (b, t, h) row.  Returns the largest
    absolute error held (0 when not held)."""
    worst = 0.0
    for out, got, want in (("y", y.float(), want_y.float()), ("s_fin", s_fin, want_s)):
        err = (got - want).abs()
        if out == "y" and dt == "bfloat16":
            rtol, atol = SSM_BF16_RTOL, 3e-5 * want.abs().mean(dim=-1, keepdim=True)
        else:
            rtol, atol = tol, torch.full_like(want[..., :1], tol)
        share = err / (atol + rtol * want.abs())
        key = f"{out}_{name}"
        row.update({f"max_abs_err_{key}": err.max().item(),
                    f"max_err_share_of_limit_{key}": share.max().item()})
        if held:
            check(row[f"max_err_share_of_limit_{key}"] <= 1.0,
                  f"ssm kernel vs {name}, {out}: {what}: {row}")
            worst = max(worst, row[f"max_abs_err_{key}"])
    return worst


def ssm_check(torch, ssm_ops, ssm_kernel, ssm_ref, device):
    """The scan kernel (through ``ops.ssm_scan``) against the plain chunked
    version, the step recurrence ``ssm_scan_ref`` and ``ssm_scan_blocked``
    (the kernel's own blocking in plain PyTorch) on the card, y and the
    final state.

    The limit is ``atol + rtol * |want|``.  fp32: rtol = atol = SSM_TOL, the
    reference's own (the step form and the chunked form add their fp32 terms
    in other orders).  bf16 (same bf16 inputs, fp32 inside): y has rtol
    SSM_BF16_RTOL for the two roundings to bf16, and an atol of 3e-5 times
    the mean |want| of each (b, t, h) row for the fp32 order of sums, which
    scales with the row's outputs; the fp32 state keeps 3e-5.  The served
    shapes are checked with no initial state, as prefill calls them; the
    others with one.  Under the ``harsh`` decay (about -20 a step) the
    plain chunked version's cumulative log decay reaches about -1000 in a
    chunk, and its fp32 rounding puts that version itself 2.8e-4 from the
    step recurrence (on the CPU, at the harsh K 64 case), beyond SSM_TOL: its
    distance is recorded there but the kernel is held to ``ssm_scan_ref``
    and ``ssm_scan_blocked``."""
    rows, worst = [], 0.0
    cases = [(c, "float32") for c in SSM_SMALL_CASES]
    cases += [(c, dt) for c in SSM_EDGE_CASES + SSM_WIDE_CASES + SSM_MAIN_CASES
              for dt in ("float32", "bfloat16")]
    for i, (case, dt) in enumerate(cases):
        q, k, v, g, s0, u = ssm_inputs(case, getattr(torch, dt), 200 + i, device, torch)
        if case in SSM_MAIN_CASES:
            s0 = None
        chunk, sub, kind = case[6:]
        before = ssm_kernel.launches
        # a scalar decay goes in as mamba's (B, T, H, 1), broadcast over K
        y, s_fin = ssm_ops.ssm_scan(q, k, v, g[..., :1] if kind == "scalar" else g, u, s0,
                                    chunk=chunk, subchunk=sub)
        torch.cuda.synchronize()
        check(ssm_kernel.launches == before + 1, f"ssm case {case}: the kernel did not launch")
        check(y.dtype == q.dtype and s_fin.dtype == torch.float32, f"ssm case {case}: dtypes")
        row = {"case": list(case), "dtype": dt}
        for name, (want_y, want_s) in (
                ("plain", ssm_ref.ssm_scan_chunked(q, k, v, g, u, s0, chunk=chunk,
                                                    subchunk=sub)),
                ("ssm_scan_ref", ssm_ref.ssm_scan_ref(q, k, v, g, u, s0)),
                ("blocked", ssm_ref.ssm_scan_blocked(q, k, v, g, u, s0))):
            # under the harsh decay the plain form is off itself: recorded, not held
            err = scan_errors(torch, y, s_fin, want_y, want_s, dt, SSM_TOL[kind], name, row,
                              held=not (kind == "harsh" and name == "plain"),
                              what=f"case {case} {dt}")
            worst = max(worst, err)
        rows.append(row)
        del q, k, v, g, s0, u, y, s_fin
    emit({"phase": "ssm_check", "ok": True, "cases": rows})
    return worst


def ssm_work(B, T, H, K, V, elem_bytes, layout="rwkv"):
    """(bytes, flops) the scan must move and do at prefill: q, k, v read and y
    written in ``elem_bytes``, g read in fp32, u read, the final state written
    in fp32; the step form's two multiply-adds per (t, k, v), 4 K V
    operations per (token, head).  ``layout="mamba"``: q and k are one row
    per (b, t) for every head, g one value per (b, t, h), and no u."""
    if layout == "mamba":
        nbytes = (elem_bytes * B * T * (2 * K + 2 * H * V) + 4 * B * T * H
                  + 4 * B * H * K * V)
    else:
        nbytes = (elem_bytes * B * T * H * (2 * K + 2 * V) + 4 * B * T * H * K
                  + 4 * H * K + 4 * B * H * K * V)
    return nbytes, 4 * K * V * B * T * H


def mamba_scan_inputs(torch, B, T, H, K, V, dtype, seed, device):
    """mamba's scan operands: q and k, (B, T, K) rows expanded over the
    heads (views), v, and g of one log decay per (b, t, h), (B, T, H, 1),
    drawn as the layer's are about: dt about 0.01, A from 1 to 16."""
    gen = torch.Generator(device).manual_seed(seed)
    c, b = (torch.randn((B, T, K), generator=gen, device=device).to(dtype) for _ in range(2))
    v = (torch.randn((B, T, H, V), generator=gen, device=device) * 0.01).to(dtype)
    a = torch.linspace(1.0, 16.0, H, device=device)
    g = (-a * 0.01 * torch.exp(torch.randn((B, T, H), generator=gen, device=device) * 0.5))
    return (c[:, :, None].expand(B, T, H, K), b[:, :, None].expand(B, T, H, K), v,
            g[..., None])


def ssm_times(torch, ssm_kernel, ssm_ref, device, plain=True, cases=SSM_MAIN_CASES):
    """Kernel / plain times and the bound at the served shapes, in bf16 as
    served: CUDA-event time over a loop of calls (``ms``) and the device
    time per launch of the kernel's records under torch.profiler over
    PROFILED_CALLS calls (``device_ms``), which a loop of events bound by
    the enqueue would not show (the mean over the records it keeps, at least
    half of them).  The bound is the larger of the bytes' and
    the step form's operations' times, both reported.  No single PyTorch
    call computes this recurrence, so there is no library time.  Without
    ``plain`` the plain version is not timed.  ``cases`` of kind "mamba"
    take mamba's layout (``mamba_scan_inputs``), in place, and the plain
    form's scalar-decay path."""
    out = []
    for i, case in enumerate(cases):
        B, T, H, K, V, _, chunk, sub, kind = case
        layout = "mamba" if kind == "mamba" else "rwkv"
        if layout == "mamba":
            q, k, v, g = mamba_scan_inputs(torch, B, T, H, K, V, torch.bfloat16, 310 + i, device)
            u = None
        else:
            q, k, v, g, _, u = ssm_inputs(case, torch.bfloat16, 300 + i, device, torch)
        nbytes, flops = ssm_work(B, T, H, K, V, elem_bytes=2, layout=layout)
        t_mem, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
        call = lambda: ssm_kernel.ssm_scan_fwd(q, k, v, g, u, None)
        ms = time_ms(call, torch)
        # the mean over the launches the profiler recorded: at mamba's shapes it
        # kept 18 of 20 records in five runs of one call (H100, torch 2.11)
        kernels, records, *_ = profile_device(
            torch, lambda: [call() for _ in range(PROFILED_CALLS)],
            complete=lambda counts: bool(counts) and all("ssm_scan_kernel" in n for n in counts)
            and sum(counts.values()) >= PROFILED_CALLS // 2)
        device_ms = sum(kernels.values()) / records
        bound = max(t_mem, t_ops)
        out.append({"B": B, "T": T, "H": H, "K": K, "V": V, "dtype": "bfloat16",
                    "layout": layout, "bytes": nbytes, "flops": flops, "ms": ms,
                    "kernel_ms": ms, "device_ms": device_ms, "profiled_records": records,
                    "plain_ms": time_ms(lambda: ssm_ref.ssm_scan_chunked(
                        q, k, v, g, u, None, chunk=chunk, subchunk=sub,
                        scalar_decay=layout == "mamba"), torch, min_s=0.5)
                    if plain else None,
                    "bound_ms": bound, "bound_by": "bytes" if t_mem >= t_ops else "operations",
                    "bytes_ms": t_mem, "operations_ms": t_ops, "library_ms": None,
                    "share_of_bound": bound / ms, "device_share_of_bound": bound / device_ms})
        del q, k, v, g, u
    emit({"phase": "ssm_times", "rows": out})
    return out


def profile_device(torch, fn, spans=(), complete=None):
    """torch.profiler over one call of ``fn``: ({kernel name: device ms},
    kernel launches, {span: device ms}, {span: device ms as key_averages
    books it}, {span: kernel ms inside it}) for the record_function ranges
    named in ``spans``; every range is kept out of the kernels.  A span's device
    ms is its extent on the device's timeline, idle gaps included; the
    kernel ms inside it sums the kernels that start within that extent
    (one stream), its busy time.  The last two are the device's busy ms,
    the union of the kernels' intervals (kernels that overlap count once),
    and the host wall ms of the same profiled call, to its synchronise:
    an idle share from one run, which cannot read negative as busy time
    from one run over the wall of others could.  The profiler can drop
    kernel records of a run; with ``complete``, a predicate on {kernel
    name: records}, the run is repeated until the records pass it,
    PROFILE_TRIES times at most."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels, counts, span_ms = {}, {}, {r: 0.0 for r in spans}
        extents, starts, intervals = {r: [] for r in spans}, [], []
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                ms = ev.time_range.elapsed_us() / 1e3
                if ev.name in span_ms:
                    span_ms[ev.name] += ms
                    extents[ev.name].append((ev.time_range.start, ev.time_range.end))
                elif not ev.is_user_annotation:
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + ms
                    counts[ev.name] = counts.get(ev.name, 0) + 1
                    starts.append((ev.time_range.start, ms))
                    intervals.append((ev.time_range.start, ev.time_range.end))
        if complete is None or complete(counts):
            break
    else:
        raise SmokeFailure(f"torch.profiler missed kernel records in {PROFILE_TRIES} runs: "
                           f"{counts}")
    cpu_side = {avg.key: getattr(avg, "device_time_total",
                                 getattr(avg, "cuda_time_total", 0.0)) / 1e3
                for avg in prof.key_averages() if avg.key in span_ms}
    busy_in = {r: sum(ms for at, ms in starts if any(a <= at < b for a, b in extents[r]))
               for r in spans}
    union_us, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        union_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return kernels, sum(counts.values()), span_ms, cpu_side, busy_in, union_us / 1e3, wall


def idle_of(busy_union_ms, profiled_wall_ms) -> dict:
    """The idle share of one profiled call: 1 - its kernels' union over its
    own wall (``profile_device``'s last two values)."""
    return {"profiled_wall_ms": profiled_wall_ms, "device_busy_union_ms": busy_union_ms,
            "idle_share": 1.0 - busy_union_ms / profiled_wall_ms}


def wall_ms(torch, fn, reps):
    """Host wall ms of each of ``reps`` calls, each ended by a synchronise."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


@contextlib.contextmanager
def plain_scan(ssm_ops, ssm_ref):
    """The plain chunked scan in place of ``ops.ssm_scan`` for the block, as
    a test's monkeypatch would swap it in."""
    def scan(q, k, v, log_decay, u=None, initial_state=None, *, chunk, subchunk, io_dtype,
             scalar_decay=False):
        return ssm_ref.ssm_scan_chunked(q, k, v, log_decay, u=u, initial_state=initial_state,
                                        chunk=chunk, subchunk=min(subchunk, chunk),
                                        scalar_decay=scalar_decay, io_dtype=io_dtype)

    kernel_scan, ssm_ops.ssm_scan = ssm_ops.ssm_scan, scan
    try:
        yield
    finally:
        ssm_ops.ssm_scan = kernel_scan


def serve_rwkv(torch, serve, build, kernels, ssm_ops, ssm_ref, device):
    """The rwkv6 serving path: full-width, full-depth rwkv6-7b through
    repro_torch.launch.serve, its scan on the kernel; one profiled prefill
    and decode step; then the same prefill in fp32 compute (the same bf16
    weights) through the kernel, through the plain chunked scan swapped in
    (as a test's monkeypatch would), and through the kernel with the
    reference's ``ssm_bf16_io`` (q, k, v rounded to bf16 at the scan), and
    the bf16 prefill through the plain scan.

    In fp32 the kernel path must give the plain path's greedy first token on
    every request and logits within FP32_LOGIT_LIMIT of it; the bf16-input
    scan must land beyond that limit, so the limit tells a scan that loses
    precision from a sound one.  In bf16 the logits must be within
    LOGIT_SLACK of the plain bf16 prefill's error against fp32; the bf16
    first tokens are printed, not compared: two sound bf16 paths differ by
    bf16 noise through 32 random-weight layers, more than some requests'
    top-2 margins."""
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_serve_step
    fa_kernel, cs_kernel, ssm_kernel = kernels
    results, launches = [], 0
    for B, S, gen_len in RWKV_WORKLOADS:
        args = serve.parse_args(["--arch", RWKV_ARCH, "--no-scaled-down", "--requests", str(B),
                                 "--prompt-len", str(S), "--gen-len", str(gen_len),
                                 "--device", str(device), "--seed", "0"])
        api, params, batch = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(RWKV_ARCH), f"not the full-width config: {cfg}")
        n_params = sum(t.numel() for t in flatten(params).values())
        serve.serve(api, params, batch, 2)  # warm-up: first-call set-up is not timed
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, batch, gen_len)
        n = ssm_kernel.launches
        launches += n
        fa_counts = flash_counts(fa_kernel)
        check(n == cfg.n_layers, f"{n} scan launches in one prefill and {gen_len - 1} decode "
                                 f"steps, want {cfg.n_layers} (one per layer, none in decode)")
        check(fa_counts == (0, 0, 0, 0) and cs_kernel.launches == 0,
              f"rwkv serving launched flash {fa_counts} (all, TMA, mma.sync, fp32) / checksum "
              f"{cs_kernel.launches} times")
        logits = res["logits"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        toks = res["tokens"]
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        # one prefill and one decode step: launches, wall time, device busy time
        step = make_serve_step(api)

        def prefill():
            return api.prefill(params, batch)

        with torch.inference_mode():
            ssm_kernel.launches = 0
            lg, cache, _ = prefill()
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            n_pre = ssm_kernel.launches
            step(params, cache, tok, S)
            n_dec = ssm_kernel.launches - n_pre
            check(n_pre == cfg.n_layers and n_dec == 0,
                  f"scan launches: {n_pre} in a prefill, {n_dec} in a decode step")
            pre_wall = statistics.median(wall_ms(torch, prefill, 3))
            by_name, pre_n, *_, pre_union, pre_pwall = profile_device(
                torch, prefill, complete=lambda counts: sum(
                    c for name, c in counts.items() if "ssm_scan_kernel" in name) == cfg.n_layers)
            pre_busy = sum(by_name.values())
            pre_ssm = sum(ms for name, ms in by_name.items() if "ssm_scan_kernel" in name)
            dec_wall = statistics.median(wall_ms(torch, lambda: step(params, cache, tok, S), 8))
            by_name, dec_n, *_, dec_union, dec_pwall = profile_device(
                torch, lambda: step(params, cache, tok, S))
            dec_busy = sum(by_name.values())
            del lg, cache

        # the same prefill in fp32 compute through the kernel (also with the
        # scan's inputs rounded to bf16), then through the plain scan in bf16
        # and in fp32
        exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
        bf16_io = build(dataclasses.replace(cfg, compute_dtype="float32", ssm_bf16_io=True),
                        device)
        ssm_kernel.launches = 0
        with torch.inference_mode():
            logits_exact_kernel, _, _ = exact.prefill(params, batch)
            logits_bf16_io, _, _ = bf16_io.prefill(params, batch)
        check(ssm_kernel.launches == 2 * cfg.n_layers,
              f"{ssm_kernel.launches} scan launches in two fp32 prefills")
        ssm_kernel.launches = 0
        with plain_scan(ssm_ops, ssm_ref), torch.inference_mode():
            logits_plain, _, _ = api.prefill(params, batch)
            logits_exact, _, _ = exact.prefill(params, batch)
        check(ssm_kernel.launches == 0, "the plain-scan prefill launched the kernel")
        diff = (logits - logits_plain).abs().max().item()
        err = (logits - logits_exact).abs().max().item()
        err_plain = (logits_plain - logits_exact).abs().max().item()
        diff32 = (logits_exact_kernel - logits_exact).abs().max().item()
        diff_bf16_io = (logits_bf16_io - logits_exact).abs().max().item()
        first, first_plain = logits[:, -1].argmax(-1), logits_plain[:, -1].argmax(-1)
        first32, first32_plain = (logits_exact_kernel[:, -1].argmax(-1),
                                  logits_exact[:, -1].argmax(-1))
        top2_32 = logits_exact[:, -1].topk(2, dim=-1).values
        row = {"arch": RWKV_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "heads": cfg.d_model // cfg.ssm.head_dim, "head_dim": cfg.ssm.head_dim,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
               "requests": B, "prompt_len": S, "gen_len": gen_len,
               "kernel_launches": n, "flash_mma_sync_launches": fa_counts[2],
               "kernel_launches_per_prefill": n_pre,
               "kernel_launches_per_decode_step": n_dec,
               "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
               "prefill_tok_s": res["prefill_tok_s"], "decode_tok_s": res["decode_tok_s"],
               "max_memory_allocated": peak_mem,
               "prefill_profile": {"wall_ms_unprofiled": pre_wall, "device_busy_ms": pre_busy,
                                   **idle_of(pre_union, pre_pwall), "kernels": pre_n,
                                   "ssm_kernel_ms": pre_ssm,
                                   "ssm_kernel_share_of_busy": pre_ssm / pre_busy},
               "decode_step_profile": {"wall_ms_unprofiled": dec_wall,
                                       "device_busy_ms": dec_busy,
                                       **idle_of(dec_union, dec_pwall),
                                       "kernels": dec_n},
               "fp32_max_abs_logit_diff_kernel_vs_plain": diff32,
               "fp32_logit_limit": FP32_LOGIT_LIMIT,
               "fp32_share_of_limit": diff32 / FP32_LOGIT_LIMIT,
               "fp32_bf16_io_max_abs_logit_diff_vs_plain": diff_bf16_io,
               "fp32_first_tokens": first32.tolist(),
               "fp32_first_tokens_plain": first32_plain.tolist(),
               "fp32_top2_margin_plain": (top2_32[:, 0] - top2_32[:, 1]).tolist(),
               "max_abs_logit_diff_vs_plain": diff,
               "max_abs_logit_err_vs_fp32": err,
               "plain_max_abs_logit_err_vs_fp32": err_plain,
               "logit_err_ratio": err / err_plain,
               "bf16_first_tokens": first.tolist(),
               "bf16_first_tokens_plain": first_plain.tolist(),
               "sample_tokens": toks[0, :8].tolist()}
        emit({"phase": "serve_rwkv", **row})
        check(bool((first32 == first32_plain).all()),
              f"fp32 greedy first tokens {first32.tolist()}, plain {first32_plain.tolist()}")
        check(diff32 <= FP32_LOGIT_LIMIT,
              f"fp32 logits {diff32} from the plain scan's, limit {FP32_LOGIT_LIMIT}")
        check(diff_bf16_io > FP32_LOGIT_LIMIT,
              f"the bf16-input scan's fp32 logits are {diff_bf16_io} from the plain "
              f"scan's, within the limit {FP32_LOGIT_LIMIT}: the limit tells nothing apart")
        check(err <= LOGIT_SLACK * err_plain,
              f"logits {err} from the fp32 prefill; the plain bf16 one is {err_plain}")
        results.append(row)
        del api, params, batch, res, logits, logits_plain, logits_exact, exact, bf16_io
        del logits_exact_kernel, logits_bf16_io
        torch.cuda.empty_cache()
    return results, launches


@contextlib.contextmanager
def routing_recorder(tf, moe):
    """Records, in call order, the experts each MoE layer of the block routes
    each token to (the sorted top-k indices of the router's fp32 softmax),
    by wrapping the model's ``moe_apply``."""
    calls = []

    def apply(p, x, cfg):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]["w"].float()
        calls.append(logits.softmax(-1).topk(cfg.moe.top_k, dim=-1).indices.sort(-1).values)
        return moe.moe_apply(p, x, cfg)

    kernel_apply, tf.moe_apply = tf.moe_apply, apply
    try:
        yield calls
    finally:
        tf.moe_apply = kernel_apply


def routing_diff(a, b):
    """(token-layer routing decisions whose expert sets differ, decisions)."""
    return (sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)),
            sum(x.shape[0] for x in a))


@contextlib.contextmanager
def bf16_attention_inputs(layers):
    """The attention kernel fed q, k, v rounded to bf16, for the block: what
    an attention kernel that loses fp32 precision on its inputs gives."""
    kernel_attention = layers.flash_attention_auto
    layers.flash_attention_auto = lambda q, k, v, **kw: kernel_attention(
        *(t.bfloat16().to(t.dtype) for t in (q, k, v)), **kw)
    try:
        yield
    finally:
        layers.flash_attention_auto = kernel_attention


def serve_moe(torch, serve, build, kernels, device):
    """The MoE serving path: full-width, full-depth granite-moe-1b-a400m
    through repro_torch.launch.serve, attention on the flash kernel (TMA
    path), the experts as batched products; one profiled prefill.  Then the
    same prefill in fp32 compute (the same bf16 weights) through the kernel
    (flash's fp32 path), through plain attention, and through the kernel
    fed bf16-rounded q, k, v; and the bf16 prefill through plain attention.

    In fp32 the kernel path must give the plain path's greedy first token on
    every request and logits within MOE_FP32_LOGIT_LIMIT of it, and the
    bf16-input kernel must land beyond that limit.  In bf16 nothing is held
    to the plain path: top-k routing turns bf16 noise into other experts, so
    the largest logit error against fp32 and the count of routing decisions
    that differ from the plain run are printed."""
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import flatten
    fa_kernel, cs_kernel, ssm_kernel = kernels
    results, launches, sync = [], 0, 0
    for B, S, gen_len in MOE_WORKLOADS:
        args = serve.parse_args(["--arch", MOE_ARCH, "--no-scaled-down", "--requests", str(B),
                                 "--prompt-len", str(S), "--gen-len", str(gen_len),
                                 "--device", str(device), "--seed", "0"])
        api, params, batch = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(MOE_ARCH), f"not the full-width config: {cfg}")
        leaves = flatten(params).values()
        n_params = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        serve.serve(api, params, batch, 2)  # warm-up: first-call set-up is not timed
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, batch, gen_len)
        n, n_tma, n_sync, n_f32 = flash_counts(fa_kernel)
        launches, sync = launches + n, sync + n_sync
        check(n == cfg.n_layers, f"{n} flash launches in one prefill, want {cfg.n_layers}")
        check(n_tma == n, f"MoE serving took the mma.sync path {n_sync} / the fp32 path "
                          f"{n_f32} times")
        check(cs_kernel.launches == 0 and ssm_kernel.launches == 0,
              f"MoE serving launched checksum {cs_kernel.launches} / scan "
              f"{ssm_kernel.launches} times")
        logits, toks = res["logits"], res["tokens"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        def prefill():
            return api.prefill(params, batch)

        with torch.inference_mode():
            reset_flash_counts(fa_kernel)
            pre_wall = statistics.median(wall_ms(torch, prefill, 3))
            pre_all, pre_tma, pre_sync, _ = flash_counts(fa_kernel)  # 3 prefills
            by_name, pre_n, *_, pre_union, pre_pwall = profile_device(
                torch, prefill, MOE_RANGES, complete=lambda counts: sum(
                    c for name, c in counts.items() if "attn_fwd_bf16_tma" in name) == cfg.n_layers)
        check(pre_all == pre_tma == 3 * cfg.n_layers and pre_sync == 0,
              f"3 prefills: {pre_all} launches, {pre_tma} TMA and {pre_sync} mma.sync")
        sync += pre_sync
        pre_busy = sum(by_name.values())
        pre_fa = sum(ms for name, ms in by_name.items() if "attn_fwd_bf16_tma" in name)
        check(pre_fa > 0, "the profiled prefill shows no attn_fwd_bf16_tma kernel")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
        exact_plain = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"),
                            device)
        before = flash_counts(fa_kernel)
        with torch.inference_mode():
            with routing_recorder(tf, moe) as r_k:
                lg_k, _, _ = api.prefill(params, batch)
            with routing_recorder(tf, moe) as r_p:
                lg_p, _, _ = plain.prefill(params, batch)
            with routing_recorder(tf, moe) as r32_k:
                lg32_k, _, _ = exact.prefill(params, batch)
            with routing_recorder(tf, moe) as r32_p:
                lg32_p, _, _ = exact_plain.prefill(params, batch)
            with bf16_attention_inputs(layers):
                lg32_bf16_in, _, _ = exact.prefill(params, batch)
        took = tuple(a - b for a, b in zip(flash_counts(fa_kernel), before))
        check(took == (3 * cfg.n_layers, cfg.n_layers, 0, 2 * cfg.n_layers),
              f"flash launches (all, TMA, mma.sync, fp32) {took} in a bf16 and two fp32 kernel "
              "prefills and two plain ones")
        diff32 = (lg32_k - lg32_p).abs().max().item()
        diff_bf16_in = (lg32_bf16_in - lg32_p).abs().max().item()
        err = (lg_k - lg32_p).abs().max().item()
        err_plain = (lg_p - lg32_p).abs().max().item()
        first32, first32_plain = lg32_k[:, -1].argmax(-1), lg32_p[:, -1].argmax(-1)
        top2_32 = lg32_p[:, -1].topk(2, dim=-1).values
        flips, decisions = routing_diff(r_k, r_p)
        flips32, _ = routing_diff(r32_k, r32_p)
        row = {"arch": MOE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
               "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k, "d_ff": cfg.d_ff,
               "vocab": cfg.vocab_size, "params": n_params, "param_bytes": n_bytes,
               "requests": B, "prompt_len": S, "gen_len": gen_len,
               "kernel_launches": n, "flash_mma_sync_launches": n_sync + pre_sync,
               "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
               "prefill_tok_s": res["prefill_tok_s"], "decode_tok_s": res["decode_tok_s"],
               "max_memory_allocated": peak_mem,
               "prefill_profile": {"wall_ms_unprofiled": pre_wall, "device_busy_ms": pre_busy,
                                   **idle_of(pre_union, pre_pwall), "kernels": pre_n,
                                   "flash_kernel_ms": pre_fa,
                                   "flash_kernel_share_of_busy": pre_fa / pre_busy,
                                   "flash_tma_launches": pre_tma // 3,
                                   "top_kernels_ms": {k[:80]: v for k, v in top}},
               "fp32_max_abs_logit_diff_kernel_vs_plain": diff32,
               "fp32_logit_limit": MOE_FP32_LOGIT_LIMIT,
               "fp32_share_of_limit": diff32 / MOE_FP32_LOGIT_LIMIT,
               "fp32_bf16_inputs_max_abs_logit_diff_vs_plain": diff_bf16_in,
               "fp32_first_tokens": first32.tolist(),
               "fp32_first_tokens_plain": first32_plain.tolist(),
               "fp32_top2_margin_plain": (top2_32[:, 0] - top2_32[:, 1]).tolist(),
               "fp32_routing_decisions_differing": flips32,
               "routing_decisions": decisions,
               "bf16_routing_decisions_differing": flips,
               "max_abs_logit_err_vs_fp32": err,
               "plain_max_abs_logit_err_vs_fp32": err_plain,
               "bf16_first_tokens": lg_k[:, -1].argmax(-1).tolist(),
               "bf16_first_tokens_plain": lg_p[:, -1].argmax(-1).tolist(),
               "sample_tokens": toks[0, :8].tolist()}
        emit({"phase": "serve_moe", **row})
        check(bool(torch.isfinite(lg32_k).all()), "non-finite fp32 logits")
        check(bool((first32 == first32_plain).all()),
              f"fp32 greedy first tokens {first32.tolist()}, plain {first32_plain.tolist()}")
        check(diff32 <= MOE_FP32_LOGIT_LIMIT,
              f"fp32 logits {diff32} from plain attention's, limit {MOE_FP32_LOGIT_LIMIT}")
        check(diff_bf16_in > MOE_FP32_LOGIT_LIMIT,
              f"the bf16-input kernel's fp32 logits are {diff_bf16_in} from plain attention's, "
              f"within the limit {MOE_FP32_LOGIT_LIMIT}: the limit tells nothing apart")
        results.append(row)
        del api, params, batch, res, logits, plain, exact, exact_plain, lg_k, lg_p, lg32_k
        del lg32_p, lg32_bf16_in, r_k, r_p, r32_k, r32_p
        torch.cuda.empty_cache()
    return results, launches, sync


@contextlib.contextmanager
def capture_scan(ssm_ops):
    """Records (args, kwargs, result) of every ``ops.ssm_scan`` call in the
    block; the calls still run the op."""
    calls = []

    def scan(*args, **kw):
        out = kernel_scan(*args, **kw)
        calls.append((args, kw, out))
        return out

    kernel_scan, ssm_ops.ssm_scan = ssm_ops.ssm_scan, scan
    try:
        yield calls
    finally:
        ssm_ops.ssm_scan = kernel_scan


def growth_bytes(torch, device, fn):
    """(peak device bytes allocated during ``fn()`` above what was allocated
    before it, fn's result)."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base, out


def mamba_scan_errors(torch, ssm_ref, q, k, v, g, y, s_fin, dt, chunks, row, what):
    """The mamba layer's scan (y, s_fin from the kernel) against the step
    recurrence and the plain scalar-decay chunked form at chunk 128 /
    subchunk 16, both held at the SSM_TOL (fp32) / SSM_BF16_RTOL (bf16)
    limits; and against the plain form at the layer's own chunks (512 /
    128), recorded, not held: there the cumulative log decay of a chunk
    reaches about -80, and the plain form's fp32 differences of it leave
    that form itself further from the step recurrence than the kernel is
    (against it alone the kernel's bf16 y exceeded the limit at B1 T5120
    on an H100, share 1.19, where it read 0.50 against the other two)."""
    worst, tag = 0.0, "" if dt == "bfloat16" else "_fp32"
    for name, held, fn in (
            ("ssm_scan_ref", True, lambda: ssm_ref.ssm_scan_ref(q, k, v, g.expand(q.shape))),
            ("plain", True, lambda: ssm_ref.ssm_scan_chunked(
                q, k, v, g, chunk=128, subchunk=16, scalar_decay=True)),
            ("plain_layer_chunks", False, lambda: ssm_ref.ssm_scan_chunked(q, k, v, g, **chunks))):
        want_y, want_s = fn()
        worst = max(worst, scan_errors(torch, y, s_fin, want_y, want_s, dt, SSM_TOL["random"],
                                       name + tag, row, held=held, what=f"{what} {dt}"))
        del want_y, want_s
    return worst


def mamba_layer(torch, kernels, ssm_ops, ssm_ref, device):
    """One jamba mamba mixer at full width (random bf16 weights from a seed)
    at each of MAMBA_SHAPES: a prefill through ``mamba_apply`` (one scan
    launch), then MAMBA_DECODE_STEPS steps through ``mamba_decode`` (none).
    Its scan, as the layer called it, is held to the step recurrence and
    the plain scalar-decay chunked form on the same operands
    (``mamba_scan_errors``): bf16 as the layer runs, and fp32 (the same
    layer on an fp32 input) at SSM_TOL; bit for bit to the kernel
    on contiguous copies of q, k and the expanded g; and the op's call may
    grow device memory by y and the state only (ALLOC_SLACK each).  One
    decode step after the fp32 prefill must give the last position of an
    fp32 prefill one token longer.  A profiled prefill gives the scan's
    share of the layer's device time; the copying call's extra memory and
    time are printed, not claimed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import flatten
    fa_kernel, cs_kernel, ssm_kernel = kernels
    cfg = get_config(HYBRID_ARCH)
    d_inner, H = tf._mamba_dims(cfg)
    K, V = cfg.ssm.d_state, cfg.ssm.head_dim
    gen = torch.Generator(device).manual_seed(0)
    p = tf.mamba_init(gen, cfg, torch.bfloat16)
    leaves = flatten(p).values()
    head = {"arch": HYBRID_ARCH, "d_model": cfg.d_model, "d_inner": d_inner, "heads": H,
            "d_state": K, "head_dim": V, "d_conv": cfg.ssm.d_conv, "chunk": cfg.ssm.chunk,
            "subchunk": cfg.ssm.subchunk, "params": sum(t.numel() for t in leaves),
            "param_bytes": sum(t.numel() * t.element_size() for t in leaves)}
    rows, launches, worst = [], 0, 0.0
    for B, T in MAMBA_SHAPES:
        x = torch.randn((B, T, cfg.d_model), generator=gen, device=device).bfloat16()
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        with torch.inference_mode(), capture_scan(ssm_ops) as calls:
            out, state = tf.mamba_apply(p, x, cfg)
            torch.cuda.synchronize()
            n_pre = ssm_kernel.launches
            for _ in range(MAMBA_DECODE_STEPS):
                xt = torch.randn((B, 1, cfg.d_model), generator=gen, device=device).bfloat16()
                o, state = tf.mamba_decode(p, xt, cfg, state)
            torch.cuda.synchronize()
        n_dec = ssm_kernel.launches - n_pre
        launches += ssm_kernel.launches
        check(n_pre == 1 and n_dec == 0 and len(calls) == 1,
              f"scan launches: {n_pre} in a prefill, {n_dec} in {MAMBA_DECODE_STEPS} decode steps")
        check(flash_counts(fa_kernel) == (0, 0, 0, 0) and cs_kernel.launches == 0,
              "the mamba layer launched flash or checksum")
        check(bool(torch.isfinite(out).all() and torch.isfinite(o).all()
                   and torch.isfinite(state[0]).all()), "non-finite mamba layer outputs")
        (q, k, v, g), kw, (y, s_fin) = calls[0][0][:4], calls[0][1], calls[0][2]
        check(q.stride(2) == 0 and k.stride(2) == 0 and tuple(g.shape) == (B, T, H, 1)
              and kw["scalar_decay"], f"the scan's operands: q {q.stride()}, k {k.stride()}, "
                                      f"g {tuple(g.shape)}, {kw}")
        row = {**head, "B": B, "T": T, "scan_launches_per_prefill": n_pre,
               "scan_launches_per_decode_step": n_dec / MAMBA_DECODE_STEPS}
        chunks = dict(chunk=kw["chunk"], subchunk=kw["subchunk"], scalar_decay=True)
        with torch.inference_mode():
            worst = max(worst, mamba_scan_errors(torch, ssm_ref, q, k, v, g, y, s_fin,
                                                 "bfloat16", chunks, row, f"mamba B{B} T{T}"))
            # bit for bit what the kernel gives on contiguous copies
            y_c, s_c = ssm_kernel.ssm_scan_fwd(q.contiguous(), k.contiguous(), v,
                                               g.expand(B, T, H, K).contiguous())
            check(torch.equal(y_c, y) and torch.equal(s_c, s_fin),
                  f"mamba B{B} T{T}: the copy-free call differs from the copying one")
            del y_c, s_c
            # device memory: the op's call against the copying call's
            free, _ = growth_bytes(torch, device, lambda: ssm_ops.ssm_scan(q, k, v, g, **chunks))
            copying, _ = growth_bytes(torch, device, lambda: ssm_kernel.ssm_scan_fwd(
                q.contiguous(), k.contiguous(), v, g.expand(B, T, H, K).contiguous()))
            limit = y.numel() * y.element_size() + s_fin.numel() * 4 + 2 * ALLOC_SLACK
            row["memory"] = {"copy_free_growth_bytes": free, "limit_bytes": limit,
                             "copying_growth_bytes": copying,
                             "copying_extra_bytes": copying - free}
            check(free <= limit, f"mamba B{B} T{T}: the scan grew device memory by {free} bytes, "
                                 f"more than y and the state ({limit})")
            row["call_ms"] = {"copy_free": time_ms(lambda: ssm_kernel.ssm_scan_fwd(q, k, v, g),
                                                   torch),
                              "copying": time_ms(lambda: ssm_kernel.ssm_scan_fwd(
                                  q.contiguous(), k.contiguous(), v,
                                  g.expand(B, T, H, K).contiguous()), torch)}

            # fp32: the same layer on the fp32 input, its scan at SSM_TOL
            x32 = x.float()
            with capture_scan(ssm_ops) as calls32:
                out32, (s32, conv32) = tf.mamba_apply(p, x32, cfg)
            (q, k, v, g), _, (y, s_fin) = calls32[0][0][:4], calls32[0][1], calls32[0][2]
            worst = max(worst, mamba_scan_errors(torch, ssm_ref, q, k, v, g, y, s_fin,
                                                 "float32", chunks, row, f"mamba B{B} T{T}"))
            del calls32
            # one decode step carries the prefill's ssm and conv state on
            xt = torch.randn((B, 1, cfg.d_model), generator=gen, device=device)
            o_dec, _ = tf.mamba_decode(p, xt, cfg, (s32, conv32))
            o_ext, _ = tf.mamba_apply(p, torch.cat([x32, xt], dim=1), cfg)
            dec_err = (o_dec[:, 0] - o_ext[:, -1]).abs().max().item()
            dec_scale = o_ext[:, -1].abs().max().item()
            row["fp32_decode_vs_longer_prefill"] = {"max_abs_diff": dec_err, "max_abs": dec_scale}
            check(dec_err <= 1e-3 * dec_scale, f"mamba B{B} T{T}: a decode step after the "
                                               f"prefill is {dec_err} from a longer prefill's "
                                               f"last position (max |out| {dec_scale})")
            del x32, out32, s32, conv32, o_dec, o_ext, q, k, v, g, y, s_fin, calls

            # the layer's prefill: wall time, device busy time, the scan's share
            layer = lambda: tf.mamba_apply(p, x, cfg)
            wall = statistics.median(wall_ms(torch, layer, 3))
            by_name, n_kernels, *_, union, pwall = profile_device(
                torch, layer, complete=lambda counts: sum(
                    c for n, c in counts.items() if "ssm_scan_kernel" in n) == 1)
        busy = sum(by_name.values())
        scan_ms = sum(ms for n, ms in by_name.items() if "ssm_scan_kernel" in n)
        row["prefill_profile"] = {"wall_ms_unprofiled": wall, "device_busy_ms": busy,
                                  **idle_of(union, pwall), "kernels": n_kernels,
                                  "scan_kernel_ms": scan_ms,
                                  "scan_kernel_share_of_busy": scan_ms / busy,
                                  "tokens_per_s": B * T / wall * 1e3}
        emit({"phase": "mamba_layer", **row})
        rows.append(row)
        del x, out, state, o
        torch.cuda.empty_cache()
    times = ssm_times(torch, ssm_kernel, ssm_ref, device, cases=MAMBA_MAIN_CASES)
    del p
    torch.cuda.empty_cache()
    return rows, times, launches, worst


def serve_hybrid(torch, serve, build, kernels, ssm_ops, ssm_ref, device):
    """The hybrid serving path: jamba scaled down (fp32) through
    repro_torch.launch.serve, its mamba layers' scan on the scan kernel and
    its attention layers on flash's fp32 path, MoE every second layer.  Then
    the prefill and the decode steps of the served tokens (teacher-forced)
    through the kernels, through plain attention and the plain scan, and
    through the kernels with the scan's inputs rounded to bf16
    (``ssm_bf16_io``): the kernel path's logits within
    HYBRID_FP32_LOGIT_LIMIT of the plain path's at every step and its
    first tokens the same; the bf16-input path beyond the limit."""
    from repro_torch.runtime.steps import make_serve_step
    fa_kernel, cs_kernel, ssm_kernel = kernels
    results, launches = [], {"scan": 0, "flash": 0}
    for B, S, gen_len in HYBRID_WORKLOADS:
        args = serve.parse_args(["--arch", HYBRID_ARCH, "--requests", str(B), "--prompt-len",
                                 str(S), "--gen-len", str(gen_len), "--device", str(device),
                                 "--seed", "0"])
        api, params, batch = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(HYBRID_ARCH).scaled_down(), f"not scaled down: {cfg}")
        kinds = cfg.block_pattern() * cfg.n_blocks
        n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
        serve.serve(api, params, batch, 2)  # warm-up
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, batch, gen_len)
        fa = flash_counts(fa_kernel)
        launches["scan"] += ssm_kernel.launches
        launches["flash"] += fa[0]
        check(ssm_kernel.launches == n_mamba, f"{ssm_kernel.launches} scan launches in a prefill "
                                              f"and {gen_len - 1} decode steps, want {n_mamba}")
        check(fa == (n_attn, 0, 0, n_attn), f"flash launches (all, TMA, mma.sync, fp32) {fa}, "
                                            f"want {n_attn} on the fp32 path")
        check(cs_kernel.launches == 0, "hybrid serving launched the checksum kernel")
        toks = res["tokens"]
        check(bool(torch.isfinite(res["logits"]).all()) and tuple(toks.shape) == (B, gen_len),
              f"logits finite, tokens {tuple(toks.shape)}")

        def run(model):
            """Prefill logits, then each decode step's on the served tokens."""
            lg, cache, _ = model.prefill(params, batch, pad_to=S + gen_len)
            out, step = [lg], make_serve_step(model, greedy=False)
            for i in range(gen_len - 1):
                lg, cache = step(params, cache, toks[:, i:i + 1], S + i)
                out.append(lg)
            return torch.cat(out, dim=1)

        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        bf16_io = build(dataclasses.replace(cfg, ssm_bf16_io=True), device)
        with torch.inference_mode():
            ssm_kernel.launches = 0
            lg_k = run(api)
            lg_b = run(bf16_io)
            check(ssm_kernel.launches == 2 * n_mamba, f"{ssm_kernel.launches} scan launches")
            with plain_scan(ssm_ops, ssm_ref):
                lg_p = run(plain)
            check(ssm_kernel.launches == 2 * n_mamba, "the plain run launched the scan kernel")
        diff = (lg_k - lg_p).abs().amax(dim=(0, 2))  # per position
        diff_b = (lg_b - lg_p).abs().max().item()
        first, first_plain = lg_k[:, 0].argmax(-1), lg_p[:, 0].argmax(-1)
        row = {"arch": HYBRID_ARCH, "scaled_down": True, "n_layers": cfg.n_layers,
               "mamba_layers": n_mamba, "attention_layers": n_attn,
               "moe_layers": sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.attn_every))
               * cfg.n_blocks, "d_model": cfg.d_model, "requests": B, "prompt_len": S,
               "gen_len": gen_len, "scan_launches": n_mamba, "flash_launches": fa[0],
               "prefill_tok_s": res["prefill_tok_s"], "decode_tok_s": res["decode_tok_s"],
               "fp32_max_abs_logit_diff_by_step": diff.tolist(),
               "fp32_logit_limit": HYBRID_FP32_LOGIT_LIMIT,
               "fp32_share_of_limit": diff.max().item() / HYBRID_FP32_LOGIT_LIMIT,
               "fp32_bf16_io_max_abs_logit_diff_vs_plain": diff_b,
               "first_tokens": first.tolist(), "first_tokens_plain": first_plain.tolist(),
               "sample_tokens": toks[0].tolist()}
        emit({"phase": "serve_hybrid", **row})
        check(bool((first == first_plain).all()),
              f"greedy first tokens {first.tolist()}, plain {first_plain.tolist()}")
        check(diff.max().item() <= HYBRID_FP32_LOGIT_LIMIT,
              f"logits {diff.tolist()} from the plain path's, limit {HYBRID_FP32_LOGIT_LIMIT}")
        check(diff_b > HYBRID_FP32_LOGIT_LIMIT,
              f"the bf16-input scan's logits are {diff_b} from the plain path's, within the "
              f"limit {HYBRID_FP32_LOGIT_LIMIT}: the limit tells nothing apart")
        results.append(row)
        del api, params, batch, res, plain, bf16_io, lg_k, lg_b, lg_p
        torch.cuda.empty_cache()
    return results, launches


def jamba2_cfg():
    """The benchmark's AI21-Jamba2-Mini configuration (a dict)."""
    with open(JAMBA2_CONFIG) as f:
        return json.load(f)


def scan1_inputs(torch, T, D, seed, device):
    """u, dt, A, B, C, D of a served Mamba-1 layer's scale at B1: bf16 u, B
    and C, dt = softplus(x - 4) in fp32, A = -(1..16) spread a channel."""
    gen = torch.Generator(device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device)
    u, b, c = (rnd(*s).to(torch.bfloat16) for s in ((1, T, D), (1, T, 16), (1, T, 16)))
    dt = torch.nn.functional.softplus(rnd(1, T, D) - 4.0)
    A = -torch.exp(torch.log(torch.arange(1, 17, device=device, dtype=torch.float32))
                   + 0.5 * (torch.rand((D, 1), generator=gen, device=device) - 0.5))
    return u, dt, A, b, c, rnd(D)


def selective_scan_check(torch, scan1_kernel, scan1_ref, device):
    """The Mamba-1 selective-scan kernel against the plain chunked form
    (``ref.selective_scan_chunked``, chunk 16) on the same rounded inputs at
    d_inner 8192, d_state 16, B1, each of SCAN1_LENGTHS: one launch a call,
    y within SCAN1_Y_TOL and the state within SCAN1_STATE_TOL of it
    (relative to 1 + |want|), and the device memory the call adds no more
    than y and the state: no (B, T, D, N) tensor.  Returns the largest
    absolute error of y."""
    from portbench.reference.jamba import dims
    n = dims(jamba2_cfg())
    rows, worst = [], 0.0
    for i, T in enumerate(SCAN1_LENGTHS):
        x = scan1_inputs(torch, T, n["di"], 400 + i, device)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launches = scan1_kernel.launches
        y, s_fin = scan1_kernel.selective_scan_fwd(*x)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - before
        check(scan1_kernel.launches == launches + 1, f"selective scan T {T}: launches")
        check(y.dtype == torch.bfloat16 and s_fin.dtype == torch.float32,
              f"selective scan T {T}: dtypes {y.dtype}, {s_fin.dtype}")
        held = y.numel() * y.element_size() + s_fin.numel() * 4
        want_y, want_s = scan1_ref.selective_scan_chunked(*x, chunk=16)
        err_y = (y.float() - want_y.float()).abs()
        err_s = (s_fin - want_s).abs()
        row = {"B": 1, "T": T, "D": n["di"], "N": n["N"], "dtype": "bfloat16",
               "max_abs_err_y": err_y.max().item(), "max_abs_err_state": err_s.max().item(),
               "max_rel_err_y": (err_y / (1 + want_y.float().abs())).max().item(),
               "max_rel_err_state": (err_s / (1 + want_s.abs())).max().item(),
               "y_tol": SCAN1_Y_TOL, "state_tol": SCAN1_STATE_TOL,
               "bytes_grown": grown, "bytes_of_y_and_state": held}
        rows.append(row)
        check(row["max_rel_err_y"] <= SCAN1_Y_TOL and row["max_rel_err_state"] <= SCAN1_STATE_TOL,
              f"selective scan kernel vs the plain chunked form: {row}")
        check(grown <= held + ALLOC_SLACK, f"selective scan T {T} grew device memory by {grown} "
                                           f"B, y and the state are {held} B")
        worst = max(worst, row["max_abs_err_y"])
        del x, y, s_fin, want_y, want_s, err_y, err_s
    emit({"phase": "selective_scan_check", "ok": True, "cases": rows})
    return worst


def selective_scan_times(torch, scan1_kernel, scan1_ref, device):
    """The selective scan's kernel and plain times at the shapes of
    ``selective_scan_check``: CUDA-event ms over a loop of calls (``ms``),
    the kernel's device ms a launch under torch.profiler over
    PROFILED_CALLS calls (``device_ms``), the plain chunked form's event ms,
    and the bound of ``portbench/counts_hybrid.py`` (the larger of the bytes
    over the HBM peak and 5 N D T operations over the fp32 peak), which the
    benchmark's ``scan_roofline.prefill_hybrid`` uses.  No PyTorch call
    computes this recurrence, so there is no library time."""
    from portbench import counts_hybrid
    from portbench.reference.jamba import dims
    cfg = jamba2_cfg()
    n = dims(cfg)
    out = []
    for i, T in enumerate(SCAN1_LENGTHS):
        x = scan1_inputs(torch, T, n["di"], 410 + i, device)
        nbytes, ops = counts_hybrid.scan_work(cfg, 1, T)
        t_mem, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
        call = lambda: scan1_kernel.selective_scan_fwd(*x)
        ms = time_ms(call, torch)
        kernels, records, *_ = profile_device(
            torch, lambda: [call() for _ in range(PROFILED_CALLS)],
            complete=lambda counts: bool(counts)
            and all("selective_scan_fwd_kernel" in k for k in counts)
            and sum(counts.values()) >= PROFILED_CALLS // 2)
        device_ms = sum(kernels.values()) / records
        bound = counts_hybrid.scan_bound_s(cfg, 1, T) * 1e3
        out.append({"B": 1, "T": T, "D": n["di"], "N": n["N"], "dtype": "bfloat16",
                    "bytes": nbytes, "operations": ops, "ms": ms, "kernel_ms": ms,
                    "device_ms": device_ms, "profiled_records": records,
                    "plain_ms": time_ms(lambda: scan1_ref.selective_scan_chunked(*x, chunk=16),
                                        torch, min_s=0.0),
                    "bound_ms": bound, "bound_by": "bytes" if t_mem >= t_ops else "operations",
                    "bytes_ms": t_mem, "operations_ms": t_ops, "library_ms": None,
                    "share_of_bound": bound / ms, "device_share_of_bound": bound / device_ms})
        del x
    emit({"phase": "selective_scan_times", "rows": out})
    return out


def serve_jamba2(torch, kernels, scan1_kernel, device):
    """The published Jamba at full width (AI21-Jamba2-Mini cut to 16 of 32
    layers, bf16: the benchmark's configuration, ``kinds/prefill_hybrid.py``'s
    program configuration and weights drawn from a seed) through
    ``registry.build`` and ``steps.make_prefill_step``, as the benchmark's
    cell serves it: a warm prefill of one JAMBA2_PROMPT-token request, then
    one with every launch counter at 0: the selective scan once a Mamba
    layer (14), flash once an attention layer (2) on the TMA path, no
    ssm_scan or checksum launch, finite logits.  Returns (row, scan
    launches, flash launches, mma.sync launches)."""
    from portbench import weights
    from portbench.kinds.common import check_layout
    from portbench.kinds.prefill_hybrid import draw, port_config
    from repro_torch.models.convert import flatten
    from repro_torch.models.registry import build
    from repro_torch.runtime import steps
    fa_kernel, cs_kernel, ssm_kernel = kernels
    cfg = jamba2_cfg()
    arch = port_config(cfg)
    kinds = arch.block_pattern() * arch.n_blocks
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api = build(arch, device)
    flat = dict(draw(torch, cfg, 0, device))
    check_layout(flatten(api.abstract_params()), flat)
    params = weights.tree(flat)
    del flat
    prefill = steps.make_prefill_step(api)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device).manual_seed(1)
    tokens = torch.randint(0, cfg["vocab_size"], (1, JAMBA2_PROMPT), generator=gen, device=device)
    prefill(params, {"tokens": tokens})  # warm-up
    torch.cuda.synchronize()
    reset_flash_counts(fa_kernel)
    cs_kernel.launches = ssm_kernel.launches = scan1_kernel.launches = 0
    t0 = time.perf_counter()
    logits, _ = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa, scans = flash_counts(fa_kernel), scan1_kernel.launches
    row = {"config": cfg["name"], "n_layers": arch.n_layers, "mamba_layers": n_mamba,
           "attention_layers": n_attn, "d_model": arch.d_model,
           "d_inner": arch.ssm.expand * arch.d_model,
           "prompt_len": JAMBA2_PROMPT, "setup_s": setup_s, "prefill_ms": wall * 1e3,
           "prefill_tok_s": JAMBA2_PROMPT / wall, "selective_scan_launches": scans,
           "flash_launches": list(fa), "ssm_scan_launches": ssm_kernel.launches,
           "checksum_launches": cs_kernel.launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit({"phase": "serve_jamba2", **row})
    check(scans == n_mamba, f"{scans} selective-scan launches in a prefill, want {n_mamba}")
    check(fa == (n_attn, n_attn, 0, 0), f"flash launches (all, TMA, mma.sync, fp32) {fa}, "
                                        f"want {n_attn} on the TMA path")
    check(ssm_kernel.launches == 0 and cs_kernel.launches == 0,
          "the published Jamba's prefill launched ssm_scan or the checksum kernel")
    check(bool(torch.isfinite(logits).all()), "the published Jamba's logits are not finite")
    del api, params, prefill, logits, tokens
    torch.cuda.empty_cache()
    return row, scans, fa[0], fa[2]


@contextlib.contextmanager
def flash_calls(fa_kernel):
    """Records (causal, Sq, Skv) of every flash kernel call in the block; the
    calls still run the kernel and count as launches."""
    calls = []

    def fwd(q, k, v, *, causal, window, **kw):
        calls.append((causal, q.shape[1], k.shape[1]))
        return kernel_fwd(q, k, v, causal=causal, window=window, **kw)

    kernel_fwd, fa_kernel.flash_attention_fwd = fa_kernel.flash_attention_fwd, fwd
    try:
        yield calls
    finally:
        fa_kernel.flash_attention_fwd = kernel_fwd


def serve_whisper(torch, serve, build, kernels, device):
    """The encoder-decoder serving path: full-width, full-depth whisper-medium
    through repro_torch.launch.serve, each request 1500 audio frames and a
    decoder prompt; the encoder's non-causal self-attention and the decoder's
    causal self-attention on the flash kernel (TMA path), the cross-attention
    plain (the reference's own choice).  One profiled prefill with the
    ``encoder`` and ``cross_attention`` ranges.  Then the same prefill in
    fp32 compute (the same bf16 weights) through the kernel (flash's fp32
    path), through plain attention, and through the kernel fed bf16-rounded
    q, k, v; and the bf16 prefill through plain attention.

    In fp32 the kernel path must give the plain path's greedy first token on
    every request and logits within WHISPER_FP32_LOGIT_LIMIT of it, and the
    bf16-input kernel must land beyond that limit; in bf16 the logit error
    against the fp32 plain prefill may be LOGIT_SLACK times the plain bf16
    prefill's.  Returns (rows, flash launches, mma.sync launches)."""
    from repro_torch.models import layers
    from repro_torch.models.convert import flatten
    fa_kernel, cs_kernel, ssm_kernel = kernels
    results, launches, sync = [], 0, 0
    for B, S, gen_len in WHISPER_WORKLOADS:
        args = serve.parse_args(["--arch", WHISPER_ARCH, "--no-scaled-down", "--requests",
                                 str(B), "--prompt-len", str(S), "--gen-len", str(gen_len),
                                 "--device", str(device), "--seed", "0"])
        api, params, batch = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(WHISPER_ARCH), f"not the full-width config: {cfg}")
        n_enc, frames = cfg.encdec.n_encoder_layers, cfg.encdec.n_audio_ctx
        per_prefill = n_enc + cfg.n_layers
        check(tuple(batch["audio_embeds"].shape) == (B, frames, cfg.d_model),
              f"audio embeddings {tuple(batch['audio_embeds'].shape)}")
        leaves = flatten(params).values()
        n_params = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        serve.serve(api, params, batch, 2)  # warm-up: first-call set-up is not timed
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        with flash_calls(fa_kernel) as calls:
            res = serve.serve(api, params, batch, gen_len)
        n, n_tma, n_sync, n_f32 = flash_counts(fa_kernel)
        launches, sync = launches + n, sync + n_sync
        non_causal = sum(1 for c, sq, skv in calls if not c and sq == skv == frames)
        causal = sum(1 for c, sq, skv in calls if c and sq == skv == S)
        check(n == per_prefill and n_tma == n,
              f"{n} flash launches in a prefill and {gen_len - 1} decode steps, {n_tma} TMA, "
              f"{n_sync} mma.sync, {n_f32} fp32; want {per_prefill} on the TMA path")
        check(non_causal == n_enc and causal == cfg.n_layers,
              f"flash calls (causal, Sq, Skv): {calls}; want {n_enc} non-causal over "
              f"{frames} frames and {cfg.n_layers} causal over {S} tokens")
        check(cs_kernel.launches == 0 and ssm_kernel.launches == 0,
              f"whisper serving launched checksum {cs_kernel.launches} / scan "
              f"{ssm_kernel.launches} times")
        logits, toks = res["logits"], res["tokens"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        def prefill():
            return api.prefill(params, batch)

        spans = ("encoder", "cross_attention")
        with torch.inference_mode():
            reset_flash_counts(fa_kernel)
            pre_wall = statistics.median(wall_ms(torch, prefill, 3))
            pre_all, pre_tma, pre_sync, _ = flash_counts(fa_kernel)  # 3 prefills
            by_name, pre_n, span_ms, _, busy_in, pre_union, pre_pwall = profile_device(
                torch, prefill, spans=spans, complete=lambda counts: sum(
                    c for name, c in counts.items() if "attn_fwd_bf16_tma" in name) == per_prefill)
        check(pre_all == pre_tma == 3 * per_prefill and pre_sync == 0,
              f"3 prefills: {pre_all} launches, {pre_tma} TMA and {pre_sync} mma.sync")
        sync += pre_sync
        pre_busy = sum(by_name.values())
        pre_fa = sum(ms for name, ms in by_name.items() if "attn_fwd_bf16_tma" in name)
        check(pre_fa > 0 and all(busy_in[r] > 0 for r in spans),
              f"the profiled prefill: flash {pre_fa} ms, in the ranges {busy_in}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
        exact_plain = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"),
                            device)
        before = flash_counts(fa_kernel)
        with torch.inference_mode():
            lg_p, _, _ = plain.prefill(params, batch)
            lg32_k, _, _ = exact.prefill(params, batch)
            lg32_p, _, _ = exact_plain.prefill(params, batch)
            with bf16_attention_inputs(layers):
                lg32_bf16_in, _, _ = exact.prefill(params, batch)
        took = tuple(a - b for a, b in zip(flash_counts(fa_kernel), before))
        check(took == (2 * per_prefill, 0, 0, 2 * per_prefill),
              f"flash launches (all, TMA, mma.sync, fp32) {took} in two fp32 kernel prefills "
              "and two plain ones")
        diff32 = (lg32_k - lg32_p).abs().max().item()
        diff_bf16_in = (lg32_bf16_in - lg32_p).abs().max().item()
        err = (logits - lg32_p).abs().max().item()
        err_plain = (lg_p - lg32_p).abs().max().item()
        first32, first32_plain = lg32_k[:, -1].argmax(-1), lg32_p[:, -1].argmax(-1)
        top2_32 = lg32_p[:, -1].topk(2, dim=-1).values
        row = {"arch": WHISPER_ARCH, "encoder_layers": n_enc, "decoder_layers": cfg.n_layers,
               "d_model": cfg.d_model, "n_heads": cfg.n_heads, "head_dim": cfg.head_dim,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
               "param_bytes": n_bytes, "requests": B, "audio_frames": frames,
               "prompt_len": S, "gen_len": gen_len, "kernel_launches": n,
               "flash_noncausal_launches": non_causal, "flash_causal_launches": causal,
               "flash_mma_sync_launches": n_sync + pre_sync,
               "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
               "prefill_tok_s": res["prefill_tok_s"],
               "prefill_audio_frames_s": B * frames / res["prefill_s"],
               "decode_tok_s": res["decode_tok_s"], "max_memory_allocated": peak_mem,
               "prefill_profile": {"wall_ms_unprofiled": pre_wall, "device_busy_ms": pre_busy,
                                   **idle_of(pre_union, pre_pwall), "kernels": pre_n,
                                   "flash_kernel_ms": pre_fa,
                                   "flash_kernel_share_of_busy": pre_fa / pre_busy,
                                   "flash_tma_launches": pre_tma // 3,
                                   "encoder_busy_ms": busy_in["encoder"],
                                   "encoder_share_of_busy": busy_in["encoder"] / pre_busy,
                                   "cross_attention_busy_ms": busy_in["cross_attention"],
                                   "cross_attention_share_of_busy":
                                       busy_in["cross_attention"] / pre_busy,
                                   "range_extent_ms": span_ms,
                                   "top_kernels_ms": {k[:80]: v for k, v in top}},
               "fp32_max_abs_logit_diff_kernel_vs_plain": diff32,
               "fp32_logit_limit": WHISPER_FP32_LOGIT_LIMIT,
               "fp32_share_of_limit": diff32 / WHISPER_FP32_LOGIT_LIMIT,
               "fp32_bf16_inputs_max_abs_logit_diff_vs_plain": diff_bf16_in,
               "fp32_first_tokens": first32.tolist(),
               "fp32_first_tokens_plain": first32_plain.tolist(),
               "fp32_top2_margin_plain": (top2_32[:, 0] - top2_32[:, 1]).tolist(),
               "max_abs_logit_err_vs_fp32": err,
               "plain_max_abs_logit_err_vs_fp32": err_plain,
               "logit_err_ratio": err / err_plain,
               "bf16_first_tokens": logits[:, -1].argmax(-1).tolist(),
               "bf16_first_tokens_plain": lg_p[:, -1].argmax(-1).tolist(),
               "sample_tokens": toks[0, :8].tolist()}
        emit({"phase": "serve_whisper", **row})
        check(bool(torch.isfinite(lg32_k).all()), "non-finite fp32 logits")
        check(bool((first32 == first32_plain).all()),
              f"fp32 greedy first tokens {first32.tolist()}, plain {first32_plain.tolist()}")
        check(diff32 <= WHISPER_FP32_LOGIT_LIMIT,
              f"fp32 logits {diff32} from plain attention's, limit {WHISPER_FP32_LOGIT_LIMIT}")
        check(diff_bf16_in > WHISPER_FP32_LOGIT_LIMIT,
              f"the bf16-input kernel's fp32 logits are {diff_bf16_in} from plain attention's, "
              f"within the limit {WHISPER_FP32_LOGIT_LIMIT}: the limit tells nothing apart")
        check(err <= LOGIT_SLACK * err_plain,
              f"logits {err} from the fp32 prefill; the plain bf16 one is {err_plain}")
        results.append(row)
        del api, params, batch, res, logits, plain, exact, exact_plain, lg_p, lg32_k, lg32_p
        del lg32_bf16_in, leaves, prefill
        torch.cuda.empty_cache()
    return results, launches, sync


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def token_losses(api, params, batch, torch):
    """Per-token xent of the batch (the terms whose mean is the loss), and
    the logsumexp, gold logit and logit variance beside it."""
    from repro_torch.models.transformer import final_hidden
    with torch.no_grad():
        x, _, _ = final_hidden(params, batch, api.cfg)
        head = (params["embed"]["table"].T if api.cfg.tie_embeddings
                else params["lm_head"]["w"])
        logits = (x @ head.to(x.dtype)).float()
        labels = batch["labels"]
        valid = labels >= 0
        gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0][valid]
        lse = torch.logsumexp(logits, dim=-1)[valid]
        return lse - gold, {"lse": lse.mean().item(), "gold": gold.mean().item(),
                            "logit_var": logits.var().item()}


def train_numerics(torch, s, params, batch, fa_kernel, device):
    """The kernel-path loss and gradients of the first batch against an fp32
    plain-attention step of the same weights, beside a bf16 plain-attention
    step.  Per gradient leaf, and for the per-token losses, the kernel
    path's relative L2 error may be LOGIT_SLACK times the plain bf16 one's;
    the mean loss may be off by LOGIT_SLACK times the plain bf16 path's RMS
    per-token error (a mean of errors is at most their RMS)."""
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.models.registry import build
    from repro_torch.runtime.steps import value_and_grad
    cfg = s.api.cfg
    plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
    exact = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"), device)
    params32 = unflatten(params, {k: v.float() for k, v in flatten(params).items()})
    reset_flash_counts(fa_kernel)
    bwd_before = fa_kernel.bwd_launches
    loss_k, _, g_k = value_and_grad(s.api, params, batch)
    counts = flash_counts(fa_kernel)
    bwd = fa_kernel.bwd_launches - bwd_before
    check(counts == (2 * cfg.n_layers, 2 * cfg.n_layers, 0, 0),
          f"flash launches (all, TMA, mma.sync, fp32) {counts} in one loss and gradient, "
          f"want {2 * cfg.n_layers} on the TMA path (forward, then the remat recompute)")
    check(bwd == cfg.n_layers, f"backward kernel launches {bwd} in one loss and gradient, "
          f"want {cfg.n_layers}")
    loss_p, _, g_p = value_and_grad(plain, params, batch)
    loss_e, _, g_e = value_and_grad(exact, params32, batch)
    check(flash_counts(fa_kernel) == counts and fa_kernel.bwd_launches - bwd_before == bwd,
          f"a plain-attention step launched the kernel: {flash_counts(fa_kernel)}")
    (tok_k, _), (tok_p, _), (tok_e, terms) = (
        token_losses(api, p, batch, torch)
        for api, p in ((s.api, params), (plain, params), (exact, params32)))
    leaves = {}
    g_k, g_p = flatten(g_k), flatten(g_p)
    for path, ge in flatten(g_e).items():
        rk, rp = rel_l2(g_k[path], ge), rel_l2(g_p[path], ge)
        leaves[path] = {"kernel": rk, "plain_bf16": rp, "ratio": rk / rp}
    tok_rk, tok_rp = rel_l2(tok_k, tok_e), rel_l2(tok_p, tok_e)
    rms_p = (tok_p - tok_e).pow(2).mean().sqrt().item()
    # the loss is held to the fp32 step's alone: untrained, it is not ln V
    # (the logits' variance and the labels' gold logits add to it), so
    # ln V and the fp32 path's terms are printed, not checked
    row = {"flash_launches": counts[0], "flash_mma_sync_launches": counts[2],
           "backward_kernel_launches": bwd,
           "loss_kernel": loss_k.item(), "loss_plain_bf16": loss_p.item(),
           "loss_fp32": loss_e.item(), "ln_vocab": math.log(cfg.vocab_size),
           "loss_terms_fp32": terms,
           "loss_err_kernel": abs(loss_k.item() - loss_e.item()),
           "loss_err_plain_bf16": abs(loss_p.item() - loss_e.item()),
           "token_loss_rms_err_plain_bf16": rms_p,
           "token_loss_rel_l2": {"kernel": tok_rk, "plain_bf16": tok_rp,
                                 "ratio": tok_rk / tok_rp},
           "max_grad_ratio": max(v["ratio"] for v in leaves.values()),
           "grad_rel_l2": leaves}
    emit({"phase": "train_numerics", **row})
    check(tok_rk <= LOGIT_SLACK * tok_rp, f"per-token losses: {row['token_loss_rel_l2']}")
    check(row["loss_err_kernel"] <= LOGIT_SLACK * rms_p,
          f"loss {row['loss_kernel']} vs fp32 {row['loss_fp32']}; plain bf16 RMS {rms_p}")
    for path, v in leaves.items():
        check(v["kernel"] <= LOGIT_SLACK * v["plain_bf16"], f"gradient of {path}: {v}")
    del g_k, g_p, g_e, params32, plain, exact
    torch.cuda.empty_cache()
    return row


def read_object(root, meta):
    """The bytes of one manifest entry as written on disk."""
    with open(os.path.join(root, meta["object"]), "rb") as f:
        f.seek(meta.get("offset", 0))
        return f.read(meta["length"]) if "length" in meta else f.read()


def train_full_width(torch, launch_train, fa_kernel, cs_kernel, ssm_kernel, device):
    """The training path: full-width training through repro_torch.launch.train,
    an injected failure, a restart, and the checkpoints' integrity.  Returns
    the two runs' flash and backward kernel launches, their checksum
    launches, the mirror's, and the mma.sync launches by run."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.core.errors import IntegrityError
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.kernels.checksum.ref import digest_ref
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_train_state
    from repro_torch.runtime.train import InjectedFailure, run_training

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        emit({"phase": "train_disk", "dir": tmp, "free_bytes": shutil.disk_usage(tmp).free})
        argv = ["--arch", ARCH, "--no-scaled-down", "--n-layers", str(TRAIN_LAYERS),
                "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                "--steps", str(TRAIN_STEPS), "--ckpt-every", str(CKPT_EVERY), "--retain", "2",
                "--data-records", "64", "--log-every", "1", "--device", str(device),
                "--seed", "0", "--ckpt-dir", tmp]
        s = launch_train.setup(launch_train.parse_args(argv + ["--fail-at-step", str(FAIL_AT)]))
        cfg = s.api.cfg
        check(cfg == dataclasses.replace(launch_train.get_config(ARCH), n_layers=TRAIN_LAYERS),
              f"not the full-width config cut to {TRAIN_LAYERS} layers: {cfg}")
        state = make_train_state(s.api, s.opt, torch.Generator(device).manual_seed(0))
        check(flatten(state)["opt/m/lm_head/w"].dtype == torch.float32
              and flatten(state)["params/lm_head/w"].dtype == torch.bfloat16,
              "want bf16 parameters and fp32 moments")
        n_leaves = len(flatten(state))
        state_bytes = sum(t.numel() * t.element_size() for t in flatten(state).values())
        first = next(ShardedTokenDataset(s.data.connector, s.data.base, s.data.cfg).batches())
        batch = {k: torch.tensor(v, device=device) for k, v in first.items()}
        numerics = train_numerics(torch, s, state["params"], batch, fa_kernel, device)

        # run 1: steps 1-4, checkpoints at 2 and 4, an injected failure before step 5
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        bwd_before = fa_kernel.bwd_launches
        cs_kernel.launches = ssm_kernel.launches = 0
        try:
            run_training(s.api, s.opt, s.loop, s.data, ckpt_mgr=s.ckpt, state=state)
            check(False, "run 1 did not stop at the injected failure")
        except InjectedFailure as exc:
            run1 = exc.result
        fa1, cs1, sync1 = fa_kernel.launches, cs_kernel.launches, fa_kernel.sync_launches
        bwd1 = fa_kernel.bwd_launches - bwd_before
        check(ssm_kernel.launches == 0, "dense training launched the scan kernel")
        check(fa_kernel.tma_launches == fa1, f"training took the mma.sync flash path {sync1} / "
                                             f"the fp32 path {fa_kernel.f32_launches} times")
        saves1 = list(s.ckpt.timings)
        check(run1.steps_run == FAIL_AT - 1 and int(state["opt"]["step"]) == FAIL_AT - 1,
              f"run 1 ran {run1.steps_run} steps")
        check(fa1 == 2 * cfg.n_layers * run1.steps_run,
              f"{fa1} flash launches in {run1.steps_run} steps, want 2 x {cfg.n_layers} per step")
        check(bwd1 == cfg.n_layers * run1.steps_run,
              f"{bwd1} backward kernel launches in {run1.steps_run} steps, want {cfg.n_layers} "
              f"per step")
        root = os.path.join(tmp, "ckpt", f"step_{FAIL_AT - 1}")
        with open(os.path.join(root, "manifest.json"), "rb") as f:
            manifest = json.loads(f.read())
        check(len(saves1) == 2 and all(t["leaves"] == n_leaves for t in saves1),
              f"saves of run 1: {saves1}")
        check(all(t["verified"] == len(manifest["objects"]) for t in saves1),
              f"post-write verification of run 1: {saves1}")
        check(cs1 == sum(t["leaves"] + t["verified"] for t in saves1),
              f"{cs1} checksum launches for {saves1}")

        # the digests on disk, recomputed on the host by numpy
        on_disk = {}
        for path, meta in (("params/embed/table", manifest["objects"]["params/embed/table"]),
                           ("opt/m/lm_head/w", manifest["objects"]["opt/m/lm_head/w"]),
                           ("params/final_norm/scale",
                            manifest["bundles"]["params/final_norm/scale"])):
            dig = digest_ref(read_object(root, meta))
            on_disk[path] = {"dtype": meta["dtype"], "manifest": meta["checksum"], "numpy": dig}
            check(dig == meta["checksum"], f"{path} on disk: numpy {dig}, manifest {meta}")

        # the restored state is byte for byte the state saved at step 4
        t0 = time.perf_counter()
        restored, step = s.ckpt.restore_latest(state)
        torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        check(step == FAIL_AT - 1, f"latest checkpoint is step {step}")
        for path, want in flatten(state).items():
            got = flatten(restored)[path]
            check(got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
                  and torch.equal(got.reshape(-1).view(torch.uint8),
                                  want.reshape(-1).view(torch.uint8)),
                  f"restored {path} differs from the state saved at step {step}")
        del restored
        torch.cuda.empty_cache()

        # the restart, as after a preemption: fresh objects, restore, steps
        # 5-6; its save at step 6 is replicated to an emulated object store
        s2 = launch_train.setup(launch_train.parse_args(
            argv + ["--replicate-to", MIRROR_PROVIDER]))
        reset_flash_counts(fa_kernel)
        bwd_before = fa_kernel.bwd_launches
        cs_kernel.launches = ssm_kernel.launches = 0
        run2 = run_training(s2.api, s2.opt, s2.loop, s2.data, ckpt_mgr=s2.ckpt,
                            replicator=s2.replicator)
        fa2, cs2, sync2 = fa_kernel.launches, cs_kernel.launches, fa_kernel.sync_launches
        bwd2 = fa_kernel.bwd_launches - bwd_before
        check(ssm_kernel.launches == 0, "the restart launched the scan kernel")
        check(fa_kernel.tma_launches == fa2, f"the restart took the mma.sync flash path {sync2} "
                                             f"/ the fp32 path {fa_kernel.f32_launches} times")
        saves2 = list(s2.ckpt.timings)
        peak_mem = torch.cuda.max_memory_allocated(device)
        check(run2.restored_from == FAIL_AT - 1 and run2.steps_run == TRAIN_STEPS - FAIL_AT + 1,
              f"restart: restored_from {run2.restored_from}, steps_run {run2.steps_run}")
        check(fa2 == 2 * cfg.n_layers * run2.steps_run, f"{fa2} flash launches in the restart")
        check(bwd2 == cfg.n_layers * run2.steps_run,
              f"{bwd2} backward kernel launches in the restart")
        check(cs2 == n_leaves + sum(t["leaves"] + t["verified"] for t in saves2),
              f"{cs2} checksum launches in the restart: {n_leaves} restored, {saves2}")
        logged = run1.losses + run2.losses + run1.grad_norms + run2.grad_norms
        check(len(run1.losses) + len(run2.losses) == TRAIN_STEPS
              and all(math.isfinite(v) for _, v in logged), f"losses and grad norms {logged}")
        check(abs(run1.losses[0][1] - numerics["loss_kernel"]) <= 1e-3 * numerics["loss_kernel"],
              f"first step's loss {run1.losses[0][1]} vs {numerics['loss_kernel']}")

        # the replica of step 6, before the byte flipped on disk below
        cs_kernel.launches = 0
        replication = mirror_check(torch, s2, state, os.path.join(tmp, "ckpt", f"step_{TRAIN_STEPS}"),
                                   n_leaves, cs_kernel)
        mirror_cs = cs_kernel.launches

        # a flipped byte in a written object fails the restore
        latest = os.path.join(tmp, "ckpt", f"step_{TRAIN_STEPS}")
        obj = os.path.join(latest, "params.embed.table.bin")
        with open(obj, "r+b") as f:
            f.seek(12345)
            byte = f.read(1)
            f.seek(12345)
            f.write(bytes([byte[0] ^ 0x10]))
        try:
            restore_checkpoint(state, s2.ckpt.connector, "ckpt", TRAIN_STEPS)
            check(False, "restore of a corrupted checkpoint did not raise")
        except IntegrityError as exc:
            corrupt = str(exc)
        check("params/embed/table" in corrupt, f"corruption reported as {corrupt!r}")

        # no step's time holds a save; the first of each run holds set-up
        step_s = run1.step_seconds[1:] + run2.step_seconds[1:]
        med = statistics.median(step_s)
        row = {"arch": ARCH, "reduced": {
                   "n_layers": [launch_train.get_config(ARCH).n_layers, TRAIN_LAYERS],
                   "why": "checkpoint bytes on disk (three checkpoints of the 2-layer "
                          "state are 17 GB) and the smoke's time limit"},
               "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
               "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
               "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "state_leaves": n_leaves,
               "state_bytes": state_bytes,
               "run1": {"steps_run": run1.steps_run, "losses": run1.losses,
                        "grad_norms": run1.grad_norms, "flash_launches": fa1,
                        "backward_kernel_launches": bwd1, "checksum_launches": cs1},
               "restart": {"restored_from": run2.restored_from, "steps_run": run2.steps_run,
                           "losses": run2.losses, "grad_norms": run2.grad_norms,
                           "flash_launches": fa2, "backward_kernel_launches": bwd2,
                           "checksum_launches": cs2},
               "step_seconds": run1.step_seconds + run2.step_seconds,
               "median_step_s_after_first": med, "steps_in_median": len(step_s),
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
               "saves": saves1 + saves2, "restore_s": restore_s,
               "replication": replication,
               "max_memory_allocated": peak_mem, "digests_on_disk": on_disk,
               "corruption": corrupt}
        emit({"phase": "train", **row})
        prof = train_profile(torch, s2, state, batch, fa_kernel)
        return fa1 + fa2, bwd1 + bwd2, cs1 + cs2, mirror_cs, {
            "train_numerics": numerics["flash_mma_sync_launches"], "train": sync1 + sync2,
            "train_profile": prof["flash_mma_sync_launches"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mirror_check(torch, s, state, root, n_leaves, cs_kernel):
    """The replica the restart's replicator made of the save in ``root``:
    one task, for step TRAIN_STEPS, SUCCEEDED with integrity on; each
    leaf's lanesum32 at the destination (the service's verified per-file
    digest for a leaf with an object of its own, the host hasher over its
    slice of the mirrored bundle otherwise) equal to the manifest digest
    the card took at save time; the mirror restored onto the card (each
    leaf digested there again) byte for byte equal to the leaves on disk;
    and one byte flipped in the mirror failing the restore of its leaf."""
    from repro_torch.ckpt import get_bytes, put_bytes, restore_checkpoint
    from repro_torch.core.errors import IntegrityError
    from repro_torch.core.integrity import checksum_bytes
    from repro_torch.models.convert import flatten
    rep = s.replicator
    check([step for step, _, _ in rep.done] == [TRAIN_STEPS],
          f"replicated steps {[step for step, _, _ in rep.done]}, want [{TRAIN_STEPS}]")
    _, task, wall_s = rep.done[0]
    with open(os.path.join(root, "manifest.json"), "rb") as f:
        manifest_raw = f.read()
    manifest = json.loads(manifest_raw)
    n_files = len(os.listdir(root))
    check(task.status == task.SUCCEEDED, f"replication {task.status}: {task.events[-5:]}")
    check(task.stats.integrity_failures == 0 and all(f.ok and f.checksum for f in task.files)
          and task.stats.files_done == task.stats.files_total == n_files,
          f"replication files: {task.stats}")
    by_file = {os.path.basename(f.dst): f.checksum for f in task.files}
    conn, base = rep.mirror.connector, f"{rep.mirror.path}/step_{TRAIN_STEPS}"
    cred = rep.service.creds.lookup(rep.mirror.endpoint_id)
    session = conn.start(cred)
    try:
        check(get_bytes(conn, session, f"{base}/manifest.json") == manifest_raw,
              "the mirror's manifest differs from the one on disk")
        at_dst = {path: by_file[meta["object"]] for path, meta in manifest["objects"].items()}
        at_dst.update({path: checksum_bytes(get_bytes(
            conn, session, f"{base}/{meta['object']}", offset=meta["offset"],
            length=meta["length"]), "lanesum32") for path, meta in manifest["bundles"].items()})
    finally:
        conn.destroy(session)
    entries = {**manifest["objects"], **manifest["bundles"]}
    check(len(at_dst) == n_leaves and all(at_dst[p] == m["checksum"] for p, m in entries.items()),
          f"destination digests differ from the card's: "
          f"{ {p: (at_dst[p], m['checksum']) for p, m in entries.items() if at_dst[p] != m['checksum']} }")

    before = cs_kernel.launches
    t0 = time.perf_counter()
    restored, step = restore_checkpoint(state, conn, rep.mirror.path, TRAIN_STEPS, credential=cred)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_cs = cs_kernel.launches - before
    check(step == TRAIN_STEPS, f"restored step {step} from the mirror")
    check(restore_cs == n_leaves, f"{restore_cs} checksum launches restoring the mirror, "
                                  f"want {n_leaves}")
    for path, got in flatten(restored).items():
        want = torch.frombuffer(bytearray(read_object(root, entries[path])), dtype=torch.uint8)
        check(got.device == flatten(state)[path].device
              and torch.equal(got.reshape(-1).view(torch.uint8).cpu(), want),
              f"{path} restored from the mirror differs from the leaf on disk")
    del restored

    # a byte flipped in the mirror fails the restore of its leaf
    path = "params/embed/table"
    obj = f"{base}/{manifest['objects'][path]['object']}"
    session = conn.start(cred)
    try:
        data = bytearray(get_bytes(conn, session, obj))
        data[12345] ^= 0x10
        put_bytes(conn, session, obj, bytes(data))
    finally:
        conn.destroy(session)
    del data
    try:
        restore_checkpoint({"params": {"embed": {"table": flatten(state)[path]}}}, conn,
                           rep.mirror.path, TRAIN_STEPS, credential=cred)
        check(False, "restore of a corrupted mirror did not raise")
    except IntegrityError as exc:
        corrupt = str(exc)
    check(path in corrupt, f"mirror corruption reported as {corrupt!r}")
    return {"provider": MIRROR_PROVIDER, "step": TRAIN_STEPS, "status": task.status,
            "integrity": True, "checksum_algorithm": "lanesum32", "files": n_files,
            "bytes": task.stats.bytes_done, "replicate_wall_s": wall_s,
            "host_mb_per_s": task.stats.bytes_done / wall_s / 1e6,
            "model_s": task.stats.actual_model_seconds,
            "leaf_digests_checked": len(at_dst),
            "leaves_by_service_digest": len(manifest["objects"]),
            "leaves_by_host_hasher": len(manifest["bundles"]),
            "restore_s": restore_s, "restore_checksum_launches": restore_cs,
            "corruption": corrupt}


def train_profile(torch, s, state, batch, fa_kernel):
    """The training rate and where a step's time goes: WARM_STEPS warm
    steps timed one by one without the profiler, then torch.profiler over
    one step, device time per kernel name and under the step's
    record_function ranges, and one layer's attention at the step's shape
    timed alone: the kernel forward, the kernel backward, the plain backward
    (the kernel's oracle) and, as the library's yardstick, SDPA's backward.
    The steps' flash launches must all take the TMA path, and each step one
    backward kernel launch a layer."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention, plain_backward
    from repro_torch.runtime.steps import make_train_step
    cfg = s.api.cfg
    step_fn = make_train_step(s.api, s.opt)
    reset_flash_counts(fa_kernel)
    bwd_before = fa_kernel.bwd_launches
    step_fn(state, batch)
    torch.cuda.synchronize()
    walls = [ms / 1e3 for ms in wall_ms(torch, lambda: step_fn(state, batch), WARM_STEPS)]
    wall = statistics.median(walls)
    # the attention backward keeps its range name on the kernel path too
    ranges = ("train_step/loss_and_grad", "train_step/adamw", "flash_attention/plain_backward")
    kernels, n_launches, spans, cpu_side, busy_in, union, pwall = profile_device(
        torch, lambda: step_fn(state, batch), ranges)
    fa_counts = flash_counts(fa_kernel)
    want = 2 * cfg.n_layers * (WARM_STEPS + 2)
    check(fa_counts == (want, want, 0, 0),
          f"flash launches (all, TMA, mma.sync, fp32) {fa_counts} in {WARM_STEPS + 2} steps, "
          f"want {want} on the TMA path")
    bwd_counts = fa_kernel.bwd_launches - bwd_before
    check(bwd_counts == cfg.n_layers * (WARM_STEPS + 2),
          f"backward kernel launches {bwd_counts} in {WARM_STEPS + 2} steps, "
          f"want {cfg.n_layers} a step")
    busy = sum(kernels.values())
    # the attention of one layer at the step's shape: kernel forward, kernel
    # and plain backward, SDPA's backward (the library's, never on the path)
    case = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            True, cfg.swa_window)
    q, k, v = (t.requires_grad_() for t in attn_inputs(case, torch.bfloat16, 11,
                                                        s.api.device, torch))
    do = torch.randn_like(q)
    chunk = min(cfg.attn_chunk, TRAIN_SEQ)
    fwd = lambda: FlashAttention.apply(q, k, v, True, cfg.swa_window, chunk)
    o = fwd()
    with torch.no_grad():
        fwd_ms = time_ms(fwd, torch)
    kbwd_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True), torch)
    bwd_ms = time_ms(lambda: plain_backward(q, k, v, do, causal=True, window=cfg.swa_window,
                                            chunk=chunk), torch)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    w = cfg.swa_window
    if w is None or w >= TRAIN_SEQ:  # SDPA's causal mask is the same mask
        sdpa = dict(is_causal=True)
    else:
        pos = torch.arange(TRAIN_SEQ, device=q.device)
        sdpa = dict(attn_mask=(pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa)
    sdpa_ms = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), do.transpose(1, 2),
                                                  retain_graph=True), torch)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    row = {"warm_steps": len(walls), "warm_step_s": walls, "median_step_s": wall,
           "min_step_s": min(walls), "max_step_s": max(walls),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
           "wall_ms_unprofiled": wall * 1e3, "device_busy_ms": busy,
           **idle_of(union, pwall), "kernels": len(kernels),
           "kernel_launches": n_launches, "flash_launches": fa_counts[0],
           "flash_mma_sync_launches": fa_counts[2],
           "device_ms_in_range": spans, "device_ms_in_range_cpu_side": cpu_side,
           "device_busy_ms_in_range": busy_in,
           "backward_kernel_launches": bwd_counts,
           "attention_layer_ms": {"kernel_forward": fwd_ms, "kernel_backward": kbwd_ms,
                                  "plain_backward": bwd_ms, "sdpa_backward": sdpa_ms,
                                  "plain_over_kernel_backward": bwd_ms / kbwd_ms,
                                  "kernel_over_sdpa_backward": kbwd_ms / sdpa_ms},
           "top_kernels_ms": {name[:80]: ms for name, ms in top}}
    emit({"phase": "train_profile", **row})
    return row


def rwkv_numerics(torch, s, params, batch, kernels, ssm_ops, ssm_ref, device):
    """The kernel-path loss and gradients of the first batch, in bf16 and
    in fp32 compute, against an fp32 step through the plain chunked scan,
    beside a bf16 step through the plain scan.  As train_numerics does for
    dense: per gradient leaf, and for the per-token losses, each kernel
    path's relative L2 error may be LOGIT_SLACK times the plain bf16 one's;
    its mean loss may be off by LOGIT_SLACK times the plain bf16 path's RMS
    per-token error."""
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.models.registry import build
    from repro_torch.runtime.steps import value_and_grad
    fa_kernel, cs_kernel, ssm_kernel = kernels
    cfg = s.api.cfg
    exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
    params32 = unflatten(params, {k: v.float() for k, v in flatten(params).items()})
    reset_flash_counts(fa_kernel)
    cs_kernel.launches = ssm_kernel.launches = 0
    loss_k, _, g_k = value_and_grad(s.api, params, batch)
    n_k = ssm_kernel.launches
    loss_k32, _, g_k32 = value_and_grad(exact, params32, batch)
    n_k32 = ssm_kernel.launches - n_k
    check(n_k == n_k32 == 2 * cfg.n_layers,
          f"scan launches {n_k} (bf16) / {n_k32} (fp32) in one loss and gradient, want "
          f"{2 * cfg.n_layers} (forward, then the remat recompute)")
    check(flash_counts(fa_kernel) == (0, 0, 0, 0) and cs_kernel.launches == 0,
          f"rwkv training launched flash {flash_counts(fa_kernel)} / checksum "
          f"{cs_kernel.launches} times")
    tok_k, _ = token_losses(s.api, params, batch, torch)
    tok_k32, _ = token_losses(exact, params32, batch, torch)
    ssm_kernel.launches = 0
    with plain_scan(ssm_ops, ssm_ref):
        loss_p, _, g_p = value_and_grad(s.api, params, batch)
        loss_e, _, g_e = value_and_grad(exact, params32, batch)
        tok_p, _ = token_losses(s.api, params, batch, torch)
        tok_e, terms = token_losses(exact, params32, batch, torch)
    check(ssm_kernel.launches == 0, "a plain-scan step launched the kernel")
    g_k, g_k32, g_p = flatten(g_k), flatten(g_k32), flatten(g_p)
    leaves = {}
    for path, ge in flatten(g_e).items():
        rk, rk32, rp = (rel_l2(g[path], ge) for g in (g_k, g_k32, g_p))
        check(all(math.isfinite(r) for r in (rk, rk32, rp)), f"gradient of {path}: not finite")
        leaves[path] = {"kernel": rk, "kernel_fp32": rk32, "plain_bf16": rp,
                        "ratio": rk / rp, "ratio_fp32": rk32 / rp}
    toks = {"kernel": rel_l2(tok_k, tok_e), "kernel_fp32": rel_l2(tok_k32, tok_e),
            "plain_bf16": rel_l2(tok_p, tok_e)}
    rms_p = (tok_p - tok_e).pow(2).mean().sqrt().item()
    row = {"scan_launches": n_k, "scan_launches_fp32": n_k32,
           "loss_kernel": loss_k.item(), "loss_kernel_fp32": loss_k32.item(),
           "loss_plain_bf16": loss_p.item(), "loss_fp32": loss_e.item(),
           "ln_vocab": math.log(cfg.vocab_size), "loss_terms_fp32": terms,
           "loss_err_kernel": abs(loss_k.item() - loss_e.item()),
           "loss_err_kernel_fp32": abs(loss_k32.item() - loss_e.item()),
           "loss_err_plain_bf16": abs(loss_p.item() - loss_e.item()),
           "token_loss_rms_err_plain_bf16": rms_p, "token_loss_rel_l2": toks,
           "max_grad_ratio": max(v["ratio"] for v in leaves.values()),
           "max_grad_ratio_fp32": max(v["ratio_fp32"] for v in leaves.values()),
           "grad_rel_l2": leaves}
    emit({"phase": "train_rwkv_numerics", **row})
    for key in ("kernel", "kernel_fp32"):
        check(toks[key] <= LOGIT_SLACK * toks["plain_bf16"], f"per-token losses: {toks}")
        check(row[f"loss_err_{key}"] <= LOGIT_SLACK * rms_p,
              f"loss ({key}) {row}; plain bf16 RMS {rms_p}")
        for path, v in leaves.items():
            check(v[key] <= LOGIT_SLACK * v["plain_bf16"], f"gradient of {path}: {v}")
    del g_k, g_k32, g_p, g_e, params32, exact
    torch.cuda.empty_cache()
    return row


def train_rwkv(torch, launch_train, kernels, ssm_ops, ssm_ref, device):
    """The rwkv6 training path: full-width rwkv6-7b cut to TRAIN_LAYERS
    layers through repro_torch.launch.train, TRAIN_BATCH x TRAIN_SEQ tokens
    a step, no checkpoint (the dense run covers that path): the numerics of
    one step, RWKV_TRAIN_STEPS steps of run_training, then the warm rate
    and a profiled step as train_profile does, with the step's device time
    split into the scan kernel, the plain scan backward (its
    record_function range), AdamW and the rest."""
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_train_state, make_train_step
    from repro_torch.runtime.train import run_training
    fa_kernel, cs_kernel, ssm_kernel = kernels
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rwkv_")
    try:
        argv = ["--arch", RWKV_ARCH, "--no-scaled-down", "--n-layers", str(TRAIN_LAYERS),
                "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                "--steps", str(RWKV_TRAIN_STEPS), "--data-records", "64", "--log-every", "1",
                "--device", str(device), "--seed", "0", "--ckpt-dir", tmp]
        s = launch_train.setup(launch_train.parse_args(argv))
        cfg = s.api.cfg
        check(cfg == dataclasses.replace(launch_train.get_config(RWKV_ARCH), n_layers=TRAIN_LAYERS),
              f"not the full-width config cut to {TRAIN_LAYERS} layers: {cfg}")
        state = make_train_state(s.api, s.opt, torch.Generator(device).manual_seed(0))
        leaves = flatten(state)
        nbytes = lambda prefix: sum(t.numel() * t.element_size() for p, t in leaves.items()
                                    if p.startswith(prefix))
        params = {p: t for p, t in leaves.items() if p.startswith("params/")}
        sizes = {"params": sum(t.numel() for t in params.values()),
                 "params_in_blocks": sum(t.numel() for p, t in params.items()
                                         if p.startswith("params/blocks/")),
                 "params_embed_and_head": sum(t.numel() for p, t in params.items()
                                              if p in ("params/embed/table", "params/lm_head/w")),
                 "param_bytes": nbytes("params/"),
                 "moment_bytes": nbytes("opt/m/") + nbytes("opt/v/"),
                 "state_bytes": nbytes(""), "state_leaves": len(leaves)}
        check(leaves["opt/m/lm_head/w"].dtype == torch.float32
              and leaves["params/lm_head/w"].dtype == torch.bfloat16,
              "want bf16 parameters and fp32 moments")
        first = next(ShardedTokenDataset(s.data.connector, s.data.base, s.data.cfg).batches())
        batch = {k: torch.tensor(v, device=device) for k, v in first.items()}
        numerics = rwkv_numerics(torch, s, state["params"], batch, kernels, ssm_ops, ssm_ref,
                                 device)

        # the run: RWKV_TRAIN_STEPS steps through run_training, no checkpoint
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        run = run_training(s.api, s.opt, s.loop, s.data, state=state)
        n_ssm, fa_run, cs_run = ssm_kernel.launches, flash_counts(fa_kernel), cs_kernel.launches
        check(run.steps_run == RWKV_TRAIN_STEPS, f"rwkv training ran {run.steps_run} steps")
        check(n_ssm == 2 * cfg.n_layers * run.steps_run,
              f"{n_ssm} scan launches in {run.steps_run} steps, want 2 x {cfg.n_layers} a step")
        check(fa_run == (0, 0, 0, 0) and cs_run == 0,
              f"rwkv training launched flash {fa_run} / checksum {cs_run} times")
        logged = run.losses + run.grad_norms
        check(len(run.losses) == RWKV_TRAIN_STEPS and all(math.isfinite(v) for _, v in logged),
              f"losses and grad norms {logged}")
        check(abs(run.losses[0][1] - numerics["loss_kernel"]) <= 1e-3 * numerics["loss_kernel"],
              f"first step's loss {run.losses[0][1]} vs {numerics['loss_kernel']}")

        # the warm rate and one profiled step
        step_fn = make_train_step(s.api, s.opt)
        ssm_kernel.launches = 0
        step_fn(state, batch)
        torch.cuda.synchronize()
        walls = [ms / 1e3 for ms in wall_ms(torch, lambda: step_fn(state, batch), WARM_STEPS)]
        wall = statistics.median(walls)
        warm_ssm = ssm_kernel.launches
        check(warm_ssm == 2 * cfg.n_layers * (WARM_STEPS + 1),
              f"{warm_ssm} scan launches in {WARM_STEPS + 1} steps")
        ranges = ("train_step/loss_and_grad", "train_step/adamw", "ssm_scan/plain_backward")
        by_name, n_launches, spans, cpu_side, busy_in, union, pwall = profile_device(
            torch, lambda: step_fn(state, batch), ranges, complete=lambda counts: sum(
                c for n, c in counts.items() if "ssm_scan_kernel" in n) == 2 * cfg.n_layers)
        prof_ssm = ssm_kernel.launches - warm_ssm
        check(prof_ssm > 0 and prof_ssm % (2 * cfg.n_layers) == 0,
              f"{prof_ssm} scan launches in the profiled steps")
        check(all(math.isfinite(t.float().sum().item()) for t in flatten(state).values()),
              "non-finite training state after the warm steps")
        peak_mem = torch.cuda.max_memory_allocated(device)
        busy = sum(by_name.values())
        scan_ms = sum(ms for n, ms in by_name.items() if "ssm_scan_kernel" in n)
        bwd_ms, adamw_ms = busy_in["ssm_scan/plain_backward"], busy_in["train_step/adamw"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        row = {"arch": RWKV_ARCH, "reduced": {
                   "n_layers": [launch_train.get_config(RWKV_ARCH).n_layers, TRAIN_LAYERS],
                   "why": "as the dense training run: the smoke's time limit"},
               "d_model": cfg.d_model, "heads": cfg.d_model // cfg.ssm.head_dim,
               "head_dim": cfg.ssm.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
               **sizes, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
               "run": {"steps_run": run.steps_run, "losses": run.losses,
                       "grad_norms": run.grad_norms, "scan_launches": n_ssm,
                       "step_seconds": run.step_seconds},
               "warm_steps": len(walls), "warm_step_s": walls, "median_step_s": wall,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
               "profile": {"wall_ms_unprofiled": wall * 1e3, "device_busy_ms": busy,
                           **idle_of(union, pwall), "kernels": len(by_name),
                           "kernel_launches": n_launches,
                           "scan_kernel_ms": scan_ms, "plain_scan_backward_ms": bwd_ms,
                           "adamw_ms": adamw_ms, "rest_ms": busy - scan_ms - bwd_ms - adamw_ms,
                           "device_ms_in_range": spans, "device_ms_in_range_cpu_side": cpu_side,
                           "device_busy_ms_in_range": busy_in,
                           "top_kernels_ms": {n[:80]: ms for n, ms in top}},
               "max_memory_allocated": peak_mem}
        emit({"phase": "train_rwkv", **row})
        return n_ssm, fa_run[2], row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def moe_numerics(torch, s, params, batch, kernels, device):
    """One fp32 training step of the MoE model (the same bf16 weights in
    fp32) through the flash kernel (its fp32 path) against the same step
    through plain attention, and through the kernel fed bf16-rounded q, k,
    v.  The kernel step's per-token losses, moe_aux and every gradient leaf
    must lie within MOE_TRAIN_FP32_LIMIT of the plain step's (losses and
    moe_aux as largest absolute differences, gradients as relative L2
    errors), and the bf16-input kernel's per-token losses beyond it.  The
    routing decisions that differ between the runs are printed."""
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.models.registry import build
    from repro_torch.runtime.steps import value_and_grad
    fa_kernel, cs_kernel, ssm_kernel = kernels
    cfg = s.api.cfg
    exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
    exact_plain = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"),
                        device)
    params32 = unflatten(params, {k: v.float() for k, v in flatten(params).items()})
    reset_flash_counts(fa_kernel)
    bwd_before = fa_kernel.bwd_launches
    with routing_recorder(tf, moe) as r_k:
        loss_k, m_k, g_k = value_and_grad(exact, params32, batch)
    counts = flash_counts(fa_kernel)
    check(counts == (2 * cfg.n_layers, 0, 0, 2 * cfg.n_layers),
          f"flash launches (all, TMA, mma.sync, fp32) {counts} in one fp32 loss and gradient, "
          f"want {2 * cfg.n_layers} on the fp32 path (forward, then the remat recompute)")
    check(fa_kernel.bwd_launches == bwd_before,
          "an fp32 loss and gradient launched the backward kernel, not the plain backward")
    with routing_recorder(tf, moe) as r_p:
        loss_p, m_p, g_p = value_and_grad(exact_plain, params32, batch)
    check(flash_counts(fa_kernel) == counts, "a plain-attention step launched the kernel")
    g_k, g_p = flatten(g_k), flatten(g_p)
    leaves = {path: rel_l2(g, g_p[path]) for path, g in g_k.items()}
    check(all(math.isfinite(r) for r in leaves.values()), f"non-finite gradients: {leaves}")
    del g_k
    with bf16_attention_inputs(layers):
        loss_b, m_b, g_b = value_and_grad(exact, params32, batch)
        tok_b, _ = token_losses(exact, params32, batch, torch)
    g_b = flatten(g_b)
    leaves_b = {path: rel_l2(g, g_p[path]) for path, g in g_b.items()}
    del g_b, g_p
    tok_k, _ = token_losses(exact, params32, batch, torch)
    tok_p, terms = token_losses(exact_plain, params32, batch, torch)
    flips, decisions = routing_diff(r_k, r_p)
    tok_diff = (tok_k - tok_p).abs().max().item()
    tok_diff_b = (tok_b - tok_p).abs().max().item()
    aux_diff = abs(m_k["moe_aux"].item() - m_p["moe_aux"].item())
    worst = max(leaves, key=leaves.get)
    row = {"flash_launches": counts[0], "flash_f32_launches": counts[3],
           "loss_kernel_fp32": loss_k.item(), "loss_plain_fp32": loss_p.item(),
           "loss_bf16_inputs": loss_b.item(), "ln_vocab": math.log(cfg.vocab_size),
           "loss_terms_fp32": terms,
           "moe_aux_kernel": m_k["moe_aux"].item(), "moe_aux_plain": m_p["moe_aux"].item(),
           "moe_aux_bf16_inputs": m_b["moe_aux"].item(), "moe_aux_abs_diff": aux_diff,
           "token_loss_max_abs_diff": tok_diff, "token_loss_max_abs_diff_bf16_inputs": tok_diff_b,
           "grad_max_rel_l2": leaves[worst], "grad_max_rel_l2_leaf": worst,
           "grad_max_rel_l2_bf16_inputs": max(leaves_b.values()),
           "fp32_limit": MOE_TRAIN_FP32_LIMIT,
           "routing_decisions": decisions, "fp32_routing_decisions_differing": flips,
           "grad_rel_l2": leaves}
    emit({"phase": "train_moe_numerics", **row})
    check(tok_diff <= MOE_TRAIN_FP32_LIMIT and aux_diff <= MOE_TRAIN_FP32_LIMIT,
          f"fp32 per-token losses {tok_diff} / moe_aux {aux_diff} from plain attention's, "
          f"limit {MOE_TRAIN_FP32_LIMIT}")
    for path, r in leaves.items():
        check(r <= MOE_TRAIN_FP32_LIMIT, f"fp32 gradient of {path}: {r} from plain attention's")
    check(tok_diff_b > MOE_TRAIN_FP32_LIMIT,
          f"the bf16-input kernel's per-token losses are {tok_diff_b} from plain attention's, "
          f"within the limit {MOE_TRAIN_FP32_LIMIT}: the limit tells nothing apart")
    del params32, exact, exact_plain
    torch.cuda.empty_cache()
    return row


def train_moe(torch, launch_train, kernels, ckpt_dir, device):
    """The MoE training path: full-width, full-depth granite-moe-1b-a400m
    (uncut) through repro_torch.launch.train, TRAIN_BATCH x TRAIN_SEQ tokens
    a step, no checkpoint manager: the fp32 numerics of one step
    (``moe_numerics``), MOE_TRAIN_STEPS steps of run_training with 2 TMA
    flash launches per layer and step (the forward, then the block remat's
    recompute), MOE_WARM_STEPS warm steps for the rate and one profiled
    step, its device time split into the flash forward, the attention
    backward (the backward kernel, one launch a layer and step), MoE
    dispatch and combine (their record_function ranges, the forward and the
    remat's recompute), AdamW and the rest.  Then the trained parameters are
    saved with save_checkpoint under ``ckpt_dir`` (lanesum32 on the card),
    for serve_sharded.  Returns (flash launches, backward kernel launches,
    mma.sync launches, checksum launches, the trained params, the row, and
    the dots steps' flash launches, backward kernel launches and row)."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.connectors.posix import PosixConnector
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_train_state, make_train_step
    from repro_torch.runtime.train import run_training
    fa_kernel, cs_kernel, ssm_kernel = kernels
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_train_")
    try:
        argv = ["--arch", MOE_ARCH, "--no-scaled-down", "--batch-size", str(TRAIN_BATCH),
                "--seq-len", str(TRAIN_SEQ), "--steps", str(MOE_TRAIN_STEPS),
                "--data-records", "64", "--log-every", "1", "--device", str(device),
                "--seed", "0", "--ckpt-dir", tmp]
        s = launch_train.setup(launch_train.parse_args(argv))
        cfg = s.api.cfg
        check(cfg == launch_train.get_config(MOE_ARCH), f"not the full config: {cfg}")
        state = make_train_state(s.api, s.opt, torch.Generator(device).manual_seed(0))
        leaves = flatten(state)
        nbytes = lambda prefix: sum(t.numel() * t.element_size() for p, t in leaves.items()
                                    if p.startswith(prefix))
        sizes = {"params": sum(t.numel() for p, t in leaves.items() if p.startswith("params/")),
                 "param_bytes": nbytes("params/"),
                 "moment_bytes": nbytes("opt/m/") + nbytes("opt/v/"),
                 "state_leaves": len(leaves)}
        check(leaves["opt/m/embed/table"].dtype == torch.float32
              and leaves["params/embed/table"].dtype == torch.bfloat16,
              "want bf16 parameters and fp32 moments")
        first = next(ShardedTokenDataset(s.data.connector, s.data.base, s.data.cfg).batches())
        batch = {k: torch.tensor(v, device=device) for k, v in first.items()}
        numerics = moe_numerics(torch, s, state["params"], batch, kernels, device)

        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        bwd_before = fa_kernel.bwd_launches
        cs_kernel.launches = ssm_kernel.launches = 0
        run = run_training(s.api, s.opt, s.loop, s.data, state=state)
        fa_run = flash_counts(fa_kernel)
        n_step = 2 * cfg.n_layers
        check(run.steps_run == MOE_TRAIN_STEPS, f"MoE training ran {run.steps_run} steps")
        check(fa_run == (n_step * run.steps_run, n_step * run.steps_run, 0, 0),
              f"flash launches (all, TMA, mma.sync, fp32) {fa_run} in {run.steps_run} steps, "
              f"want {n_step} a step on the TMA path")
        bwd_run = fa_kernel.bwd_launches - bwd_before
        check(bwd_run == cfg.n_layers * run.steps_run,
              f"backward kernel launches {bwd_run} in {run.steps_run} steps, "
              f"want {cfg.n_layers} a step")
        check(cs_kernel.launches == 0 and ssm_kernel.launches == 0,
              f"MoE training launched checksum {cs_kernel.launches} / scan "
              f"{ssm_kernel.launches} times")
        logged = run.losses + run.grad_norms
        check(len(run.losses) == MOE_TRAIN_STEPS and all(math.isfinite(v) for _, v in logged),
              f"losses and grad norms {logged}")

        step_fn = make_train_step(s.api, s.opt)
        step_fn(state, batch)
        torch.cuda.synchronize()
        reset_flash_counts(fa_kernel)
        walls = [ms / 1e3 for ms in wall_ms(torch, lambda: step_fn(state, batch), MOE_WARM_STEPS)]
        warm_fa = flash_counts(fa_kernel)
        check(warm_fa == (n_step * MOE_WARM_STEPS, n_step * MOE_WARM_STEPS, 0, 0),
              f"flash launches {warm_fa} in {MOE_WARM_STEPS} warm steps")
        wall = statistics.median(walls)
        by_name, n_launches, spans, cpu_side, busy_in, union, pwall = profile_device(
            torch, lambda: step_fn(state, batch), MOE_STEP_RANGES, complete=lambda counts: sum(
                c for n, c in counts.items() if "attn_fwd_bf16_tma" in n) == n_step)
        check(all(math.isfinite(t.float().sum().item()) for t in flatten(state).values()),
              "non-finite training state after the warm steps")
        peak_mem = torch.cuda.max_memory_allocated(device)
        # one more step, its peak above what was allocated before it: the
        # counterpart of the roofline phase's peak live bytes above the arguments
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        step_fn(state, batch)
        torch.cuda.synchronize(device)
        step_max = torch.cuda.max_memory_allocated(device)
        step_memory = {"allocated_before": before, "max_allocated": step_max,
                       "peak_above_allocated": step_max - before}
        busy = sum(by_name.values())
        fa_ms = sum(ms for n, ms in by_name.items() if "attn_fwd" in n)
        split = {"flash_forward_ms": fa_ms,
                 "attention_backward_ms": busy_in["flash_attention/plain_backward"],
                 "moe_dispatch_ms": busy_in["moe/dispatch"],
                 "moe_combine_ms": busy_in["moe/combine"],
                 "adamw_ms": busy_in["train_step/adamw"]}
        split["rest_ms"] = busy - sum(split.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

        # remat="dots" on the same model, state and batch (its timed steps
        # train the state on, before the save)
        block_profile = {"device_busy_ms": busy, **idle_of(union, pwall),
                         "kernel_launches": n_launches, "device_busy_ms_in_range": busy_in}
        dots_fa, dots_bwd, dots_row = train_moe_dots(torch, s, state, batch, fa_kernel,
                                                     step_memory, wall, block_profile, device)

        # the trained parameters, saved for serve_sharded: lanesum32 on the card
        params = state["params"]
        cs_kernel.launches = 0
        t0 = time.perf_counter()
        manifest = save_checkpoint(params, PosixConnector(ckpt_dir), "ckpt", step=run.steps_run)
        save_s = time.perf_counter() - t0
        n_leaves = len(flatten(params))
        want_cs = n_leaves + len(manifest["objects"])  # source digests, post-write verify
        check(cs_kernel.launches == want_cs,
              f"{cs_kernel.launches} checksum launches saving {n_leaves} leaves, want {want_cs}")
        row = {"arch": MOE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
               "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k, "d_ff": cfg.d_ff,
               "vocab": cfg.vocab_size, **sizes, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
               "run": {"steps_run": run.steps_run, "losses": run.losses,
                       "grad_norms": run.grad_norms, "step_seconds": run.step_seconds},
               "flash_launches_per_step": n_step,
               "warm_steps": len(walls), "warm_step_s": walls, "median_step_s": wall,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
               "profile": {"wall_ms_unprofiled": wall * 1e3, "device_busy_ms": busy,
                           **idle_of(union, pwall), "kernels": len(by_name),
                           "kernel_launches": n_launches, **split,
                           "device_ms_in_range": spans, "device_ms_in_range_cpu_side": cpu_side,
                           "device_busy_ms_in_range": busy_in,
                           "top_kernels_ms": {n[:80]: ms for n, ms in top}},
               "max_memory_allocated": peak_mem, "step_memory": step_memory,
               "save": {"leaves": n_leaves, "objects": len(manifest["objects"]),
                        "checksum_launches": cs_kernel.launches, "seconds": save_s}}
        emit({"phase": "train_moe", **row})
        del state, s, leaves, batch, numerics
        torch.cuda.empty_cache()
        # the main path's launches: run_training's steps and the save, and
        # the dots steps'
        return (fa_run[0], bwd_run, fa_run[2], cs_kernel.launches, params, row, dots_fa,
                dots_bwd, dots_row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mm_counts(torch, api, params, batch):
    """({op: count} in the forward, {op: count} in the backward) of the
    matrix products (``aten.mm``, ``aten.addmm``, ``aten.bmm``) one loss and
    gradient dispatches: cuBLAS launches, the kernels' ctypes calls apart."""
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.roofline import ProductCounter

    leaves = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    with ProductCounter() as fwd:
        loss, _ = api.loss(unflatten(params, leaves), batch)
    with ProductCounter() as bwd:
        torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    return dict(fwd.ops), dict(bwd.ops)


def loss_and_grad_memory(torch, api, params, batch, device):
    """(bytes held from the end of the forward to the backward, the peak of
    the forward and backward), both above what was allocated before one
    loss and gradient on the card: the first is what autograd and the
    checkpoint keep for the backward (under "dots" the saved products)."""
    from repro_torch.models.convert import flatten, unflatten
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    leaves = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    loss, _ = api.loss(unflatten(params, leaves), batch)
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device) - before
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - before
    del grads, loss
    return held, peak


def train_moe_dots(torch, s, state, batch, fa_kernel, block_memory, block_step_s,
                   block_profile, device):
    """``remat="dots"`` (the selective checkpoint: matrix products without a
    batch dimension saved, the rest recomputed) on ``train_moe``'s model,
    state and batch: one fp32 loss and gradient against the block remat's
    within DOTS_FP32_LIMIT (the block step run twice gives the atomics'
    spread); the products each backward dispatches under both; then
    MOE_WARM_STEPS timed bf16 steps through make_train_step, 2 TMA flash
    launches per layer and step (the forward, then the recompute: the
    kernel is not a saved product), one profiled step's device busy time
    and idle share, and one more step's peak above what was allocated
    before it, beside the block steps' (``block_memory``, ``block_step_s``,
    ``block_profile``); the bytes each holds from its forward to its
    backward (dots' above block's: the saved products) and the peak of its
    loss and gradient alone.  Returns (flash launches, backward kernel
    launches, the row)."""
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.models.registry import build
    from repro_torch.runtime.steps import make_train_step, value_and_grad
    cfg = s.api.cfg
    dots = build(dataclasses.replace(cfg, remat="dots"), device)
    # fp32 numerics: the same weights in fp32, block against dots
    params32 = unflatten(state["params"], {k: v.float() for k, v in
                                           flatten(state["params"]).items()})
    ex_block = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
    ex_dots = build(dataclasses.replace(cfg, compute_dtype="float32", remat="dots"), device)
    loss_b, m_b, g_b = value_and_grad(ex_block, params32, batch)
    g_b = flatten(g_b)
    loss_b2, _, g_b2 = value_and_grad(ex_block, params32, batch)
    spread = {p: rel_l2(g, g_b[p]) for p, g in flatten(g_b2).items()}
    del g_b2
    loss_d, m_d, g_d = value_and_grad(ex_dots, params32, batch)
    leaves = {p: rel_l2(g, g_b[p]) for p, g in flatten(g_d).items()}
    del g_d, g_b, params32
    loss_rel = abs(loss_d.item() - loss_b.item()) / abs(loss_b.item())
    # the products each backward dispatches, bf16
    fwd_b, bwd_b = mm_counts(torch, s.api, state["params"], batch)
    fwd_d, bwd_d = mm_counts(torch, dots, state["params"], batch)
    torch.cuda.empty_cache()
    # what each holds for its backward, and the peak of its loss and gradient
    held_b, grad_peak_b = loss_and_grad_memory(torch, s.api, state["params"], batch, device)
    held_d, grad_peak_d = loss_and_grad_memory(torch, dots, state["params"], batch, device)
    torch.cuda.empty_cache()
    # timed bf16 steps and the peak of one more
    step_fn = make_train_step(dots, s.opt)
    step_fn(state, batch)
    torch.cuda.synchronize()
    reset_flash_counts(fa_kernel)
    bwd_before = fa_kernel.bwd_launches
    walls = [ms / 1e3 for ms in wall_ms(torch, lambda: step_fn(state, batch), MOE_WARM_STEPS)]
    fa = flash_counts(fa_kernel)
    bwd = fa_kernel.bwd_launches - bwd_before
    n_step = 2 * cfg.n_layers
    by_name, n_launches, _, _, busy_in, union, pwall = profile_device(
        torch, lambda: step_fn(state, batch), MOE_STEP_RANGES, complete=lambda counts: sum(
            c for n, c in counts.items() if "attn_fwd_bf16_tma" in n) == n_step)
    profile = {"device_busy_ms": sum(by_name.values()), **idle_of(union, pwall),
               "kernel_launches": n_launches, "device_busy_ms_in_range": busy_in}
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    _, metrics = step_fn(state, batch)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - before
    wall = statistics.median(walls)
    worst = max(leaves, key=leaves.get)
    row = {"arch": MOE_ARCH, "remat": "dots", "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "loss_fp32_dots": loss_d.item(), "loss_fp32_block": loss_b.item(),
           "loss_fp32_block_rerun": loss_b2.item(), "loss_rel_diff": loss_rel,
           "moe_aux_abs_diff": abs(m_d["moe_aux"].item() - m_b["moe_aux"].item()),
           "grad_max_rel_l2": leaves[worst], "grad_max_rel_l2_leaf": worst,
           "block_rerun_grad_max_rel_l2": max(spread.values()), "fp32_limit": DOTS_FP32_LIMIT,
           "forward_products_block": fwd_b, "forward_products_dots": fwd_d,
           "backward_products_block": bwd_b, "backward_products_dots": bwd_d,
           "backward_mm_saved": bwd_b.get("mm", 0) - bwd_d.get("mm", 0),
           "flash_launches_per_step": fa[0] / MOE_WARM_STEPS,
           "backward_kernel_launches_per_step": bwd / MOE_WARM_STEPS,
           "warm_steps": len(walls), "warm_step_s": walls, "median_step_s": wall,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
           "block_median_step_s": block_step_s, "step_s_over_block": wall / block_step_s,
           "profile": profile, "block_profile": block_profile,
           "busy_over_block": profile["device_busy_ms"] / block_profile["device_busy_ms"],
           "step_peak_above_allocated": peak,
           "block_step_peak_above_allocated": block_memory["peak_above_allocated"],
           "peak_over_block": peak / block_memory["peak_above_allocated"],
           "held_for_backward": held_d, "block_held_for_backward": held_b,
           "held_over_block": held_d - held_b,
           "loss_and_grad_peak": grad_peak_d, "block_loss_and_grad_peak": grad_peak_b,
           "last_loss": metrics["loss"].item()}
    emit({"phase": "train_moe_dots", **row})
    check(fa == (n_step * MOE_WARM_STEPS, n_step * MOE_WARM_STEPS, 0, 0),
          f"flash launches (all, TMA, mma.sync, fp32) {fa} in {MOE_WARM_STEPS} dots steps, "
          f"want {n_step} a step on the TMA path")
    check(bwd == cfg.n_layers * MOE_WARM_STEPS,
          f"backward kernel launches {bwd} in {MOE_WARM_STEPS} dots steps, "
          f"want {cfg.n_layers} a step")
    check(loss_rel <= DOTS_FP32_LIMIT and row["moe_aux_abs_diff"] <= DOTS_FP32_LIMIT,
          f"dots loss {loss_rel} / moe_aux {row['moe_aux_abs_diff']} from block's")
    for path, r in leaves.items():
        check(r <= DOTS_FP32_LIMIT, f"dots gradient of {path}: {r} from block's")
    check(fwd_b == fwd_d and bwd_d.get("mm", 0) < bwd_b.get("mm", 0)
          and bwd_d.get("bmm", 0) == bwd_b.get("bmm", 0),
          f"products: forward {fwd_b} / {fwd_d}, backward block {bwd_b}, dots {bwd_d}")
    check(held_d > held_b, f"dots holds {held_d} bytes for its backward, block {held_b}")
    check(math.isfinite(row["last_loss"]), f"dots step loss {row['last_loss']}")
    return fa[0], bwd, row


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_case(torch, kernels, mesh, arch, cfg, params, dparams, batch, n_dec, device,
                 timed=False):
    """One served model through build_cell's prefill and decode steps on
    ``mesh`` (``dparams`` the DTensor params) against the same prefill and
    decode steps unsharded (``params``): logits, greedy tokens and the
    kernels' launches, and with ``timed`` both prefills' wall ms (in turns:
    unsharded, sharded, sharded, unsharded) and a profiled prefill each."""
    from repro_torch.launch.cells import build_cell, distribute_like
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import build
    from repro_torch.runtime.steps import make_serve_step
    from torch.distributed.tensor import DTensor
    fa_kernel, cs_kernel, ssm_kernel = kernels
    B, S = batch["tokens"].shape
    pre = build_cell(arch, ShapeConfig("serve_sharded", S, B, "prefill"), mesh, cfg=cfg,
                     pad_to=S + n_dec)
    dec = build_cell(arch, ShapeConfig("serve_sharded", S + n_dec, B, "decode"), mesh, cfg=cfg)
    dbatch = distribute_like(batch, pre.in_shardings[1], mesh)
    api = build(cfg, device)
    serve_step = make_serve_step(api)
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t

    def unsharded():
        return api.prefill(params, batch, pad_to=S + n_dec)[:2]

    def sharded():
        return pre.step_fn(dparams, dbatch)

    with torch.inference_mode():
        lg_u, cache_u = unsharded()
    reset_flash_counts(fa_kernel)
    ssm_kernel.launches = 0
    lg_s, cache_s = sharded()
    fa_pre, scan_pre = flash_counts(fa_kernel), ssm_kernel.launches
    check(isinstance(lg_s, DTensor), "the sharded prefill did not return a DTensor")
    diff = (local(lg_s) - lg_u).abs().max().item()
    first_u, first_s = lg_u[:, -1].argmax(-1), local(lg_s)[:, -1].argmax(-1)
    tok_u, tok_s = first_u[:, None].int(), distribute_like(
        first_s[:, None].int(), dec.in_shardings[2], mesh)
    toks_u, toks_s, dec_diff = [tok_u], [local(tok_s)], 0
    reset_flash_counts(fa_kernel)
    ssm_kernel.launches = 0
    for i in range(n_dec):
        with torch.inference_mode():
            tok_u, cache_u = serve_step(params, cache_u, tok_u, S + i)
        tok_s, cache_s = dec.step_fn(dparams, cache_s, tok_s, S + i)
        toks_u.append(tok_u)
        toks_s.append(local(tok_s))
    fa_dec, scan_dec = flash_counts(fa_kernel), ssm_kernel.launches
    for key, t in cache_u.items():
        dec_diff = max(dec_diff, (local(cache_s[key]).float() - t.float()).abs().max().item())
    toks_u, toks_s = torch.cat(toks_u, 1), torch.cat(toks_s, 1)
    row = {"arch": arch, "compute_dtype": cfg.compute_dtype, "requests": B, "prompt_len": S,
           "decode_steps": n_dec,
           "placements": {"logits": [str(p) for p in lg_s.placements],
                          **{k: [str(p) for p in v.placements] for k, v in cache_s.items()}},
           "prefill_flash_launches": list(fa_pre), "prefill_scan_launches": scan_pre,
           "decode_flash_launches": list(fa_dec), "decode_scan_launches": scan_dec,
           "max_abs_logit_diff_vs_unsharded": diff,
           "max_abs_cache_diff_after_decode": dec_diff,
           "first_tokens": first_s.tolist(), "first_tokens_unsharded": first_u.tolist(),
           "decode_tokens_equal": bool(torch.equal(toks_s, toks_u)),
           "sample_tokens": toks_s[0].tolist()}
    if timed:
        walls = {"unsharded": [], "sharded": []}
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            fn = unsharded if name == "unsharded" else sharded
            with torch.inference_mode() if name == "unsharded" else contextlib.nullcontext():
                walls[name] += wall_ms(torch, fn, 3)
        prof = {}
        for name, fn in (("unsharded", unsharded), ("sharded", sharded)):
            with torch.inference_mode() if name == "unsharded" else contextlib.nullcontext():
                by_name, n, *_, union, pwall = profile_device(
                    torch, fn, MOE_RANGES, complete=lambda counts: sum(
                        c for k, c in counts.items() if "attn_fwd" in k) == fa_pre[0])
            busy, wall = sum(by_name.values()), statistics.median(walls[name])
            prof[name] = {"wall_ms": walls[name], "wall_ms_median": wall,
                          "device_busy_ms": busy, **idle_of(union, pwall),
                          "kernels": n, "top_kernels_ms": {k[:80]: v for k, v in sorted(
                              by_name.items(), key=lambda kv: -kv[1])[:6]}}
        prof["host_ms_added"] = (prof["sharded"]["wall_ms_median"]
                                 - prof["unsharded"]["wall_ms_median"])
        row["prefill_profile"] = prof
    return row


def serve_sharded(torch, kernels, ckpt_dir, trained, device):
    """The sharding layer on the card: a one-rank NCCL group and a (1, 1)
    ("data", "model") CUDA mesh.  granite-moe-1b-a400m's parameters come
    from train_moe's checkpoint through restore_checkpoint with the prefill
    cell's placements (each leaf read, its lanesum32 verified on the card,
    kept as a DTensor) and must equal the trained ones byte for byte; its
    SHARDED_WORKLOAD runs through build_cell's prefill and decode steps in
    bf16 (24 TMA flash launches a prefill through local_map, the greedy
    first tokens of the unsharded run; walls and idle shares of both
    prefills) and in fp32 compute (24 launches on flash's fp32 path, logits
    within SHARDED_FP32_LIMIT of the unsharded fp32 prefill's).  Then jamba
    scaled down in fp32 (HYBRID_WORKLOADS) the same way: the scan kernel
    once per mamba layer and flash once per attention layer, both through
    local_map.  Every placement is trivial on one rank, so the sharded run
    should be bit-equal.  The group is torn down before returning."""
    import torch.distributed as dist
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.connectors.posix import PosixConnector
    from repro_torch.launch import serve
    from repro_torch.launch.cells import build_cell, distribute_like
    from repro_torch.launch.mesh import make_test_mesh, mesh_info
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.convert import flatten
    from repro_torch.models.registry import build
    fa_kernel, cs_kernel, ssm_kernel = kernels
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(1, 1, device_type="cuda")
        rows, launches = [], {"flash": 0, "scan": 0, "checksum": 0, "sync": 0}
        cfg = serve.get_config(MOE_ARCH)
        B, S, n_dec = SHARDED_WORKLOAD
        cell = build_cell(MOE_ARCH, ShapeConfig("serve_sharded", S, B, "prefill"), mesh,
                          cfg=cfg, pad_to=S + n_dec)
        cs_kernel.launches = 0
        t0 = time.perf_counter()
        dparams, step = restore_checkpoint(build(cfg, device).abstract_params(),
                                           PosixConnector(ckpt_dir), "ckpt",
                                           shardings=cell.in_shardings[0])
        restore_s = time.perf_counter() - t0
        n_leaves = len(flatten(trained))
        launches["checksum"] = cs_kernel.launches
        check(cs_kernel.launches == n_leaves,
              f"{cs_kernel.launches} checksum launches restoring {n_leaves} leaves")
        flat = flatten(dparams)
        check(all(torch.equal(flat[k].to_local(), v) for k, v in flatten(trained).items()),
              "the restored shards differ from the trained parameters")
        gen = torch.Generator(device).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                         device=device)}
        for compute in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, compute_dtype=compute)
            row = sharded_case(torch, kernels, mesh, MOE_ARCH, c, trained, dparams, batch,
                               n_dec, device, timed=compute == "bfloat16")
            row.update(mesh=mesh_info(mesh), restored_step=step, restore_s=restore_s,
                       restore_checksum_launches=n_leaves)
            emit({"phase": "serve_sharded", **row})
            fa = row["prefill_flash_launches"]
            launches["flash"] += fa[0] + row["decode_flash_launches"][0]
            launches["sync"] += fa[2] + row["decode_flash_launches"][2]
            path = 1 if compute == "bfloat16" else 3  # the TMA or the fp32 path
            check(fa[0] == fa[path] == cfg.n_layers and row["decode_flash_launches"][0] == 0,
                  f"flash launches {fa} a sharded prefill, want {cfg.n_layers} on one path")
            check(row["first_tokens"] == row["first_tokens_unsharded"],
                  f"sharded first tokens {row['first_tokens']}, unsharded "
                  f"{row['first_tokens_unsharded']}")
            if compute == "float32":
                check(row["max_abs_logit_diff_vs_unsharded"] <= SHARDED_FP32_LIMIT,
                      f"sharded fp32 logits {row['max_abs_logit_diff_vs_unsharded']} from the "
                      f"unsharded ones, limit {SHARDED_FP32_LIMIT}")
            rows.append(row)
        del dparams, cell
        torch.cuda.empty_cache()

        # jamba scaled down in fp32: the scan's and flash's fp32 path under the mesh
        for B, S, gen_len in HYBRID_WORKLOADS:
            args = serve.parse_args(["--arch", HYBRID_ARCH, "--requests", str(B),
                                     "--prompt-len", str(S), "--device", str(device),
                                     "--seed", "0"])
            api, params, batch = serve.setup(args)
            cfg = api.cfg
            kinds = cfg.block_pattern() * cfg.n_blocks
            n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
            cell = build_cell(HYBRID_ARCH, ShapeConfig("serve_sharded", S, B, "prefill"), mesh,
                              cfg=cfg)
            dparams = distribute_like(params, cell.in_shardings[0], mesh)
            row = sharded_case(torch, kernels, mesh, HYBRID_ARCH, cfg, params, dparams, batch,
                               gen_len - 1, device)
            row["mesh"] = mesh_info(mesh)
            emit({"phase": "serve_sharded", **row})
            fa = row["prefill_flash_launches"]
            launches["flash"] += fa[0]
            launches["sync"] += fa[2]
            launches["scan"] += row["prefill_scan_launches"] + row["decode_scan_launches"]
            check(row["prefill_scan_launches"] == n_mamba and row["decode_scan_launches"] == 0,
                  f"scan launches {row['prefill_scan_launches']} a sharded prefill, want "
                  f"{n_mamba}, and {row['decode_scan_launches']} in decode")
            check(fa == [n_attn, 0, 0, n_attn], f"flash launches {fa} a sharded prefill, want "
                                                f"{n_attn} on the fp32 path")
            check(row["first_tokens"] == row["first_tokens_unsharded"],
                  f"sharded first tokens {row['first_tokens']}, unsharded "
                  f"{row['first_tokens_unsharded']}")
            check(row["max_abs_logit_diff_vs_unsharded"] <= SHARDED_FP32_LIMIT,
                  f"sharded fp32 logits {row['max_abs_logit_diff_vs_unsharded']} from the "
                  f"unsharded ones, limit {SHARDED_FP32_LIMIT}")
            rows.append(row)
            del api, params, dparams, cell
            torch.cuda.empty_cache()
        return rows, launches
    finally:
        dist.destroy_process_group()


def fed_schedules(seed):
    """The federated copies' fault schedules: (the cluster store's, {store:
    its own}).  On the cluster store, the source: the first per-file send of
    every file fails with a transient error, and so does about one 4 MiB
    block in 500 mid-stream, after real progress.  On each destination store: the
    first two streams of every file into the first two replicas' paths are
    cut after 1 MiB each (two, so that a stream the site failure paused
    before its first MiB does not use up the file's cut).  A truncated stream is a fault of the bytes a store
    receives (the fault proxy applies data faults there, so that a source
    checksum still sees the bytes the source sent), so it sits on the
    stores that receive; every other fault is the source's."""
    from repro_torch.core.faults import FaultSchedule
    src = (FaultSchedule(seed=seed)
           .transient(op="send", at=1, times=1)
           .transient(op="write", prob=0.002, times=None))
    dst = {store: FaultSchedule(seed=seed + 1 + i).truncate(
        after_bytes=1 << 20, op="recv*", path="replica/*", at=1, times=2)
        for i, store in enumerate(FED_STORES.values())}
    return src, dst


def federate(torch, kernels, ckpt_dir, trained, device, smi, hold_bytes=FED_HOLD_BYTES):
    """The paper's third-party replication, federated over sites: the
    checkpoint train_moe saved in ``ckpt_dir`` (its lanesum32 digests taken
    on the card) copied to two emulated object stores through a
    FederatedCoordinator over three TransferManager sites on one
    Clock(scale=0.0) sharing one ReplicaCatalog: s0 owns the cluster's
    POSIX store (behind a FaultProxyConnector and the source-side fault
    schedule), s1 an s3 store, s2 a gcs store (each behind a proxy that
    cuts streams into it).  Both copies are submitted through
    TransferSpec's JSON wire form (integrity on, lanesum32, as
    ckpt/replicate.py sets them) and placed at s0, the source's owner; the
    source holds after ``hold_bytes`` have streamed, and s0 is failed with
    both copies mid-flight: each is paused, drained and handed to a peer
    with its traveled markers.  Then a third copy of the same checkpoint to
    a second path of the s3 store, which the catalog must serve from the
    s3 replica, reading no byte of the source.  Every replica's manifest
    must be the card's, and each replica must restore through
    restore_checkpoint (each leaf's lanesum32 computed by the checksum
    kernel on the card from the replica's bytes, against the manifest's)
    byte for byte equal to ``trained``.  Returns the row."""
    import threading
    from repro_torch.catalog import ReplicaCatalog
    from repro_torch.ckpt import get_bytes, restore_checkpoint
    from repro_torch.connectors import (FaultProxyConnector, ObjectStoreConnector,
                                        PosixConnector, make_cloud)
    from repro_torch.core import Clock, Credential
    from repro_torch.core.manager import TransferManager
    from repro_torch.core.transfer import CredentialStore, TransferOptions
    from repro_torch.fed import FederatedCoordinator, TransferSpec
    from repro_torch.models.convert import flatten
    # the scenario harness's hold on the source and its byte meters
    from repro_torch.sim.scenarios import _HoldSrc, _InstrumentedDst, _MeteredSrc
    fa_kernel, cs_kernel, ssm_kernel = kernels
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    with open(os.path.join(ckpt_dir, "ckpt", "LATEST")) as f:
        step = int(f.read())
    src_path = f"ckpt/step_{step}"
    names = sorted(os.listdir(os.path.join(ckpt_dir, src_path)))
    nbytes = sum(os.path.getsize(os.path.join(ckpt_dir, src_path, n)) for n in names)
    with open(os.path.join(ckpt_dir, src_path, "manifest.json"), "rb") as f:
        manifest_raw = f.read()
    manifest = json.loads(manifest_raw)
    n_leaves = len(manifest["objects"]) + len(manifest["bundles"])
    check(n_leaves == len(flatten(trained)), f"{n_leaves} leaves in the checkpoint")

    clock = Clock(scale=0.0)
    src_sched, dst_scheds = fed_schedules(FED_SEED)
    hold = _HoldSrc(PosixConnector(ckpt_dir))
    metered = _MeteredSrc(hold)
    endpoints = {"cluster": FaultProxyConnector(metered, src_sched, clock=clock)}
    stores, landed = {}, {}
    for store in FED_STORES.values():
        stores[store] = ObjectStoreConnector(make_cloud(store, clock=clock), placement="cloud",
                                             clock=clock)
        landed[store] = _InstrumentedDst(stores[store])
        endpoints[store] = FaultProxyConnector(landed[store], dst_scheds[store], clock=clock)
    creds = {"cluster": Credential("local-user", {}),
             **{store: Credential(conn.credential_scheme, {}) for store, conn in stores.items()}}
    catalog = ReplicaCatalog()
    coord = FederatedCoordinator(placement="owner", catalog=catalog)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fed_")
    reset_flash_counts(fa_kernel)
    cs_kernel.launches = ssm_kernel.launches = 0
    try:
        for site, owns in {"s0": {"cluster"}, **{s: {st} for s, st in FED_STORES.items()}}.items():
            store = CredentialStore()
            for ep, cred in creds.items():
                store.register(ep, cred)
            manager = TransferManager(max_workers=2, per_endpoint_cap=None, credential_store=store,
                                      catalog=catalog, marker_root=os.path.join(tmp, site),
                                      clock=clock, site_id=site)
            coord.register_site(site, manager, endpoints, owns=owns)
        opts = TransferOptions(integrity=True, checksum_algorithm="lanesum32")

        def spec(task_id, store, path):
            return TransferSpec.new(task_id, "cluster", src_path, store, f"{path}/step_{step}",
                                    tenant=FED_TENANT, options=opts, n_files=len(names),
                                    nbytes=nbytes)

        copies = {store: spec(f"fed-{store}", store, "replica/ckpt") for store in stores}
        hold.arm_hold([src_path + "/"], hold_bytes)
        t0 = time.perf_counter()
        for s in copies.values():
            coord.submit(s.to_json())
        placed = {tid: site for tid, site, why in coord.metrics.placement_log if why == "submit"}
        check(set(placed.values()) == {"s0"}, f"copies placed at {placed}, not at the source's owner")

        # the site failure, with both copies mid-flight (run_federated's sequence)
        check(hold.engaged.wait(FED_TIMEOUT), "the source never held: no copy was mid-flight")
        victims = [coord.task(s.task_id) for s in copies.values()]
        t_end = time.perf_counter() + FED_TIMEOUT
        while not any(t.stats.bytes_done > 0 for t in victims) and time.perf_counter() < t_end:
            time.sleep(0.002)
        check(any(t.stats.bytes_done > 0 for t in victims), "no copy landed a byte before the hold")
        landed_before = {s.task_id: coord.task(s.task_id).stats.bytes_done for s in copies.values()}
        moved, errors = [], []

        def fail():
            try:
                moved.extend(coord.fail_site("s0", timeout=FED_TIMEOUT))
            except Exception as exc:  # surfaced by the check below
                errors.append(exc)

        t_fail = time.perf_counter()
        failer = threading.Thread(target=fail, daemon=True)
        failer.start()
        while time.perf_counter() < t_end and not all(
                t._done.is_set() or t._pause_req.is_set() or t.status == t.PAUSED for t in victims):
            time.sleep(0.005)
        hold.release()
        failer.join(FED_TIMEOUT)
        fail_s = time.perf_counter() - t_fail
        check(not failer.is_alive() and not errors, f"fail_site: {errors or 'wedged'}")
        check(len(moved) >= 1 and all(site != "s0" for _, site in moved),
              f"the site failure moved {moved}")
        traveled = {tid: coord.last_spec(tid).done_bytes() for tid, _ in moved}
        check(any(v > 0 for v in traveled.values()),
              f"no handed-off copy carried partial progress: {traveled}")

        done_at = {}

        def waiter(store, task_id):
            if coord.task(task_id).wait(FED_TIMEOUT):
                done_at[store] = time.perf_counter()

        waiters = [threading.Thread(target=waiter, args=(store, s.task_id), daemon=True)
                   for store, s in copies.items()]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join(FED_TIMEOUT)
        rows = {}
        for store, s in copies.items():
            task = coord.task(s.task_id)
            st = task.stats
            check(task.status == task.SUCCEEDED and store in done_at,
                  f"copy to {store}: {task.status}: {task.events[-5:]}")
            check(st.files_done == st.files_total == len(names) and st.bytes_total == nbytes
                  and all(f.ok and f.checksum for f in task.files if f.size),
                  f"copy to {store}: {st}")
            # beyond the checkpoint's size: the heads of truncated streams
            # written again, and any block the site failure's pause cut
            written = landed[store].written(f"replica/ckpt/step_{step}/")
            check(written >= nbytes, f"{written} bytes landed in {store} for {nbytes}")
            wall = done_at[store] - t0
            rows[store] = {"task": s.task_id, "site": st.site, "origin_site": st.origin_site,
                           "tenant": st.tenant, "wall_s": wall, "mb_per_s": nbytes / wall / 1e6,
                           "model_s": st.actual_model_seconds, "resumes": st.resumes,
                           "faults_retried": st.faults_retried,
                           "retries_by_kind": dict(st.retries_by_kind),
                           "integrity_failures": st.integrity_failures,
                           "batch_fallbacks": st.batch_fallbacks,
                           "bytes_landed_before_failure": landed_before[s.task_id],
                           "bytes_written": written, "bytes_resent": written - nbytes}
        for tid, site in moved:
            st = coord.task(tid).stats
            check(st.site == site and st.origin_site == "s0" and st.tenant == FED_TENANT
                  and st.resumes >= 1,
                  f"{tid} after its handoff to {site}: site {st.site}, origin {st.origin_site}, "
                  f"tenant {st.tenant}, resumes {st.resumes}")
        injected = {"source": src_sched.sorted_events(),
                    **{store: sched.sorted_events() for store, sched in dst_scheds.items()}}
        kinds = {}
        for events in injected.values():
            for kind, *_ in events:
                kinds[kind] = kinds.get(kind, 0) + 1
        retried = sum(r["faults_retried"] for r in rows.values())
        check(kinds.get("transient", 0) > 0 and kinds.get("truncate", 0) > 0 and retried > 0,
              f"faults injected {kinds}, retried {retried}")

        # the third copy: served by the catalog from the s3 replica
        sent_before = metered.sent(src_path)
        third = spec("fed-s3-catalog", "s3", "replica2/ckpt")
        t3 = time.perf_counter()
        task = coord.submit(third.to_json())
        check(task.wait(FED_TIMEOUT), "the third copy did not finish")
        third_s = time.perf_counter() - t3
        st = task.stats
        check(task.status == task.SUCCEEDED, f"third copy {task.status}: {task.events[-5:]}")
        check(st.replica_hits == len(names) and st.replica_bytes == st.bytes_total == nbytes
              and st.replica_fallbacks == 0 and metered.sent(src_path) == sent_before,
              f"third copy: {st.replica_hits} catalog hits of {len(names)} files, "
              f"{st.replica_bytes} of {nbytes} bytes from replicas, {st.replica_fallbacks} "
              f"fallbacks, {metered.sent(src_path) - sent_before} bytes read from the source")
        rows["s3_catalog"] = {"task": third.task_id, "site": st.site, "wall_s": third_s,
                              "mb_per_s": nbytes / third_s / 1e6,
                              "model_s": st.actual_model_seconds,
                              "replica_hits": st.replica_hits, "replica_bytes": st.replica_bytes,
                              "replica_fallbacks": st.replica_fallbacks,
                              "source_bytes_read": metered.sent(src_path) - sent_before}
        coordinator_s = coord.model_seconds()
        check(coordinator_s == 0.0,
              f"third-party violation: the coordinator accrued {coordinator_s} model seconds")
        coord.shutdown(wait=False)

        # each replica: the card's manifest, restored byte for byte, every
        # leaf's lanesum32 taken by the kernel from the replica's bytes
        leaves = flatten(trained)
        want = {p: t.reshape(-1).view(torch.uint8) for p, t in leaves.items()}
        restores = {}
        for name, (store, base) in {"s3": ("s3", "replica/ckpt"),
                                    "gcs": ("gcs", "replica/ckpt"),
                                    "s3_catalog": ("s3", "replica2/ckpt")}.items():
            conn, cred = stores[store], creds[store]
            session = conn.start(cred)
            try:
                check(get_bytes(conn, session, f"{base}/step_{step}/manifest.json") == manifest_raw,
                      f"the {name} replica's manifest is not the one the card wrote")
            finally:
                conn.destroy(session)
            before = cs_kernel.launches
            t_r = time.perf_counter()
            restored, got_step = restore_checkpoint(trained, conn, base, step, credential=cred)
            if cuda:
                torch.cuda.synchronize(device)
            launches = cs_kernel.launches - before
            check(got_step == step and launches == (n_leaves if cuda else 0),
                  f"{name}: restored step {got_step} with {launches} checksum launches for "
                  f"{n_leaves} leaves")
            for path, got in flatten(restored).items():
                check(got.device == leaves[path].device
                      and torch.equal(got.reshape(-1).view(torch.uint8), want[path]),
                      f"{path} restored from the {name} replica differs from the trained leaf")
            del restored
            restores[name] = {"seconds": time.perf_counter() - t_r, "checksum_launches": launches,
                              "leaf_digests_checked": n_leaves}
        fa_run = flash_counts(fa_kernel)
        check(fa_run[0] == 0 and ssm_kernel.launches == 0,
              f"federate launched flash {fa_run} / scan {ssm_kernel.launches} times")
        row = {"phase": "federate", "arch": MOE_ARCH, "step": step, "files": len(names),
               "bytes": nbytes, "leaves": n_leaves, "nvidia_smi": smi,
               "placed": placed, "handoffs": [
                   {"task": tid, "from": "s0", "to": site, "bytes_traveled": traveled[tid],
                    "bytes_resent": rows[tid.removeprefix("fed-")]["bytes_resent"]}
                   for tid, site in moved],
               "fail_site_s": fail_s, "copies": rows,
               "faults_injected": kinds, "faults_retried": retried,
               "catalog": {"hits": rows["s3_catalog"]["replica_hits"], **catalog.stats()},
               "coordinator_model_s": coordinator_s, "restores": restores,
               "checksum_launches": cs_kernel.launches, "seconds": time.perf_counter() - t_phase}
        emit(row)
        return row
    finally:
        coord.shutdown(wait=False)
        hold.release()
        for conn in stores.values():  # the replicas held in host memory
            for key in list(conn.storage.blobs.keys()):
                conn.storage.blobs.delete(key)
        shutil.rmtree(tmp, ignore_errors=True)


def background(argv, log_path, cwd=ROOT):
    """``argv`` in a process group of its own at the lowest CPU priority,
    output to ``log_path``: the phases' host work goes first."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    with open(log_path, "w") as log:
        return subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=cwd,
                                start_new_session=True, preexec_fn=lambda: os.nice(19))


def start_dryrun(results_dir):
    """The port's dry run of every single-pod cell on the 16x16 mesh,
    started in its own process: its fake process group must not meet
    serve_sharded's real one.  It needs no device, so it runs beside the
    build and the phases."""
    return background([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                       "--single-pod-only", "--results-dir", results_dir],
                      os.path.join(results_dir, "dryrun.log"))


def start_perf_iter(results_dir):
    """scripts/perf_iter_torch.py on PERF_ITER_CELL under each of
    PERF_ITER_REMATS, one after the other in one process group, records
    appended under ``results_dir``: the port's dry run under this machine's
    torch with the reference's perf-iteration toggles."""
    arch, shape = PERF_ITER_CELL
    script = os.path.join(ROOT, "scripts", "perf_iter_torch.py")
    runs = [f"{sys.executable} {script} --arch {arch} --shape {shape} --set remat={r} "
            f"--tag remat_{r} --full-memory" for r in PERF_ITER_REMATS]
    return background(["bash", "-c", " && ".join(runs)],
                      os.path.join(results_dir, "perf_iter.log"), cwd=results_dir)


def start_sharded_gloo(results_dir):
    """pytest over each group of GLOO_TESTS in a process of its own, beside
    the build: the sharding layer's gloo groups on the machine's CPU
    (ROADMAP C15).  Returns the processes."""
    return [background([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        *group, "-k", "not match_reference", "--junitxml",
                        os.path.join(results_dir, f"gloo{i}.xml")],
                       os.path.join(results_dir, f"gloo{i}.log"))
            for i, group in enumerate(GLOO_TESTS)]


def stop(proc) -> None:
    """Kills ``proc``'s process group (pytest's spawned ranks with it)."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def wait_for(proc, limit, t0, what):
    """Waits for ``proc``, started at ``t0``, ``limit`` seconds at most."""
    try:
        proc.wait(timeout=max(1.0, limit - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop(proc)
        raise SmokeFailure(f"{what} took more than {limit} s")
    return time.perf_counter() - t0


def sharded_gloo_phase(procs, results_dir, t0, torch_version):
    """Waits for ``start_sharded_gloo``'s pytest processes; every case must
    pass."""
    import xml.etree.ElementTree as ET
    outcome, own, tails, seconds = {}, [], [], []
    for i, proc in enumerate(procs):
        seconds.append(wait_for(proc, GLOO_TIMEOUT, t0, "the gloo cases"))
        with open(os.path.join(results_dir, f"gloo{i}.log")) as f:
            tails += f.read().splitlines()[-6:]
        xml_path = os.path.join(results_dir, f"gloo{i}.xml")
        if os.path.exists(xml_path):
            root = ET.parse(xml_path).getroot()
            own.append(sum(float(suite.get("time", 0)) for suite in root.iter("testsuite")))
            for case in root.iter("testcase"):
                kind = next((c.tag for c in case if c.tag in ("failure", "error", "skipped")),
                            "passed")
                outcome[f"{case.get('classname', '').split('.')[-1]}::{case.get('name')}"] = kind
    bad = {k: v for k, v in outcome.items() if v != "passed"}
    codes = [proc.returncode for proc in procs]
    row = {"ranks": "CPU processes of gloo groups, not the card", "torch": torch_version,
           "files": list(GLOO_TESTS), "passed": len(outcome) - len(bad), "not_passed": bad,
           "pytest_seconds": own, "waited_until_s": seconds, "cases": outcome}
    check(codes == [0] * len(procs) and outcome and not bad,
          f"the gloo cases failed (exits {codes}): {bad} | {' | '.join(tails)}")
    emit({"phase": "sharded_gloo", **row})
    return row


def dryrun_phase(proc, results_dir, t0, torch_version):
    """Waits for ``start_dryrun``'s process: every single-pod cell ``ok``
    with its temps counted; DRYRUN_CELL's roofline terms, memory and
    seconds, and its counts over DRYRUN_CPU_READING's."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.common import cells_for
    seconds = wait_for(proc, DRYRUN_TIMEOUT, t0, "the dry run")
    with open(os.path.join(results_dir, "dryrun.log")) as f:
        out = f.read()
    lines = [ln for ln in out.splitlines() if "]:W" not in ln]
    check(proc.returncode == 0 and "ALL DRY-RUN CELLS PASSED" in out,
          f"the dry run failed (exit {proc.returncode}): {' | '.join(lines[-8:])}")
    cells = {}
    for arch in ARCH_IDS:
        for shape in cells_for(arch):
            with open(os.path.join(results_dir, f"dryrun_{arch}_{shape}_16x16.json")) as f:
                rec = json.load(f)
            cells[f"{arch} x {shape}"] = rec
    summary = {name: {k: rec.get(k) for k in ("ok", "t_compute", "t_memory", "t_collective",
                                              "bottleneck", "useful_ratio",
                                              "bytes_per_dev_argument", "bytes_per_dev_temp",
                                              "fits_hbm", "seconds")}
               for name, rec in cells.items()}
    check(len(cells) == 34 and all(r["ok"] and r["bytes_per_dev_temp"] is not None
                                   and r["bytes_per_dev_temp"] > 0 for r in cells.values()),
          f"dry-run records not ok or without temps: "
          f"{[n for n, r in cells.items() if not r['ok'] or not r['bytes_per_dev_temp']]}")
    arch, shape = DRYRUN_CELL
    rec = cells[f"{arch} x {shape}"]
    row = {"cell": f"{arch} x {shape} @ 16x16",
           "terms": next(ln.strip() for ln in lines if f"{arch} x {shape} [16x16]" in ln),
           **{k: rec[k] for k in ("ok", "hw", "n_devices", "hlo_flops_per_dev",
                                  "hlo_bytes_per_dev", "coll_bytes_per_dev", "t_compute",
                                  "t_memory", "t_collective", "bottleneck", "useful_ratio",
                                  "peak_fraction", "bytes_per_dev_argument",
                                  "bytes_per_dev_temp", "bytes_per_dev_output", "fits_hbm",
                                  "lower_seconds", "count_seconds", "seconds")},
           "coll_count": rec["coll_detail"]["count"], "torch": torch_version,
           "over_cpu_reading": {k: rec[k] / v for k, v in DRYRUN_CPU_READING.items()
                                if k != "torch"},
           "cpu_reading_torch": DRYRUN_CPU_READING["torch"],
           "cells_ok": sum(r["ok"] for r in cells.values()),
           "cells_fit_hbm": sum(bool(r["fits_hbm"]) for r in cells.values()),
           "cells_seconds": sum(r["seconds"] for r in cells.values()),
           "waited_until_s": seconds, "cells": summary}
    check(row["ok"] and row["hlo_flops_per_dev"] > 0 and row["coll_bytes_per_dev"] > 0,
          f"the dry run's record {row}")
    emit({"phase": "dryrun", **row})
    return row


def perf_iter_phase(proc, results_dir, t0, torch_version):
    """Waits for ``start_perf_iter``'s counts: one record per remat, the
    three roofline terms against HW_H100 and the full-depth temps; "dots"
    counts fewer FLOPs than "block" (its recompute skips the saved
    products) and holds at least block's temps (the saved outputs)."""
    seconds = wait_for(proc, PERF_ITER_TIMEOUT, t0, "perf_iter_torch.py")
    with open(os.path.join(results_dir, "perf_iter.log")) as f:
        tail = [ln for ln in f.read().splitlines() if "]:W" not in ln][-6:]
    check(proc.returncode == 0, f"perf_iter_torch.py failed (exit {proc.returncode}): "
                                f"{' | '.join(tail)}")
    with open(os.path.join(results_dir, "results", "torch", "perf_iters.jsonl")) as f:
        recs = {r["tag"]: r for r in map(json.loads, f)}
    keys = ("hlo_flops_per_dev", "hlo_bytes_per_dev", "coll_bytes_per_dev", "t_compute",
            "t_memory", "t_collective", "bottleneck", "useful_ratio", "bytes_per_dev_argument",
            "bytes_per_dev_temp", "wall_seconds")
    runs = {r: {k: recs[f"remat_{r}"][k] for k in keys} for r in PERF_ITER_REMATS}
    ratio = {k: runs["dots"][k] / runs["block"][k]
             for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev", "coll_bytes_per_dev",
                       "bytes_per_dev_temp")}
    row = {"cell": f"{PERF_ITER_CELL[0]} x {PERF_ITER_CELL[1]} @ 16x16", "torch": torch_version,
           "hw": recs["remat_dots"]["hw"], "runs": runs, "dots_over_block": ratio,
           "waited_until_s": seconds}
    emit({"phase": "perf_iter", **row})
    check(ratio["hlo_flops_per_dev"] < 1.0 and ratio["bytes_per_dev_temp"] >= 1.0,
          f"dots against block: {ratio}")
    return row


def roofline_phase(torch, moe_row, dots_row):
    """``train_moe``'s step counted on ``meta`` (the same config, 2 x 2048
    tokens, one card, so no collectives) and set against HW_H100 beside the
    step's measured seconds and busy ms, and its peak live bytes above the
    train state and batch beside the same step's measured peak above what
    was allocated before it, and with the state's bytes beside the phase's
    ``max_memory_allocated``.  On ``meta`` the flash forward is counted as
    the plain chunked form the dispatcher runs there.  The same for
    ``train_moe_dots``' step (``dots_row``): its peak against the measured
    one, the bytes the dots forward holds for the backward above the block
    forward's, and each remat's loss and gradient peak (the step's peak
    is AdamW's, past the saved products), counted against measured,
    within PEAK_MATCH either way."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import build, train_batch_specs
    from repro_torch.optim import OptimizerConfig
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.roofline import HW_H100, CostCounter, LiveBytes, cost_numbers, model_flops
    from repro_torch.runtime.steps import abstract_train_state, make_train_step
    cfg = get_config(MOE_ARCH)
    shape = ShapeConfig("train_moe", TRAIN_SEQ, TRAIN_BATCH, "train")
    api, opt = build(cfg, "meta"), OptimizerConfig(state_dtype="float32")
    state, batch = abstract_train_state(api, opt), train_batch_specs(cfg, shape)
    args = sum(t.numel() * t.element_size()
               for t in (*flatten(state).values(), *batch.values()))
    t0 = time.perf_counter()
    with CostCounter() as counter, LiveBytes() as live:
        make_train_step(api, opt)(state, batch)
    nums, count_s = cost_numbers(counter.record()), time.perf_counter() - t0
    dots = build(dataclasses.replace(cfg, remat="dots"), "meta")
    with LiveBytes() as dots_live:
        make_train_step(dots, opt)(state, batch)
    held, grad_peak = {}, {}
    for remat, a in (("block", api), ("dots", dots)):
        leaves = {k: v.detach().requires_grad_() for k, v in flatten(state["params"]).items()}
        with LiveBytes() as grad_live:
            loss, _ = a.loss(unflatten(state["params"], leaves), batch)
            held[remat] = grad_live.live
            torch.autograd.grad(loss, list(leaves.values()))
        grad_peak[remat] = grad_live.peak
        del loss, leaves
    measured_grad_peak = {"block": dots_row["block_loss_and_grad_peak"],
                          "dots": dots_row["loss_and_grad_peak"]}
    mem = moe_row["step_memory"]
    mf = model_flops(cfg, shape)
    step_s, busy_ms = moe_row["median_step_s"], moe_row["profile"]["device_busy_ms"]
    total = torch.cuda.get_device_properties(0).total_memory
    row = {"cell": f"{MOE_ARCH} train 2 x 2048, one card", "hw": HW_H100.name,
           "count_seconds": count_s, "flops": nums["flops"], "bytes": nums["bytes"],
           "model_flops": mf, "t_compute": nums["flops"] / HW_H100.peak_flops_bf16,
           "t_memory": nums["bytes"] / HW_H100.hbm_bw,
           "t_model_flops": mf / HW_H100.peak_flops_bf16,
           "measured_step_s": step_s, "measured_busy_ms": busy_ms,
           "achieved_share_of_peak": nums["flops"] / step_s / HW_H100.peak_flops_bf16,
           "model_flops_share_of_peak": mf / step_s / HW_H100.peak_flops_bf16,
           "busy_share_of_peak": nums["flops"] / (busy_ms / 1e3) / HW_H100.peak_flops_bf16,
           "hbm_bytes": HW_H100.hbm_bytes, "device_total_memory": total,
           "counted_argument_bytes": args, "counted_peak_above_arguments": live.peak,
           "measured_step_peak_above_allocated": mem["peak_above_allocated"],
           "peak_ratio": live.peak / mem["peak_above_allocated"],
           "counted_total_bytes": args + live.peak,
           "measured_max_memory_allocated": moe_row["max_memory_allocated"],
           "total_ratio": (args + live.peak) / moe_row["max_memory_allocated"],
           "dots_counted_peak_above_arguments": dots_live.peak,
           "dots_measured_step_peak_above_allocated": dots_row["step_peak_above_allocated"],
           "dots_peak_ratio": dots_live.peak / dots_row["step_peak_above_allocated"],
           "counted_held_for_backward": held,
           "dots_counted_held_over_block": held["dots"] - held["block"],
           "dots_measured_held_over_block": dots_row["held_over_block"],
           "dots_held_over_block_ratio": ((held["dots"] - held["block"])
                                          / dots_row["held_over_block"]),
           "counted_loss_and_grad_peak": grad_peak,
           "measured_loss_and_grad_peak": measured_grad_peak,
           "loss_and_grad_peak_ratio": {r: grad_peak[r] / measured_grad_peak[r]
                                        for r in grad_peak}}
    check(abs(HW_H100.hbm_bytes - total) <= HBM_MATCH * total,
          f"HW_H100.hbm_bytes {HW_H100.hbm_bytes} against the card's {total}")
    check(1 / PEAK_MATCH <= row["peak_ratio"] <= PEAK_MATCH,
          f"counted peak {live.peak} bytes against the measured {mem['peak_above_allocated']}")
    check(1 / PEAK_MATCH <= row["dots_peak_ratio"] <= PEAK_MATCH,
          f"counted dots peak {dots_live.peak} bytes against the measured "
          f"{dots_row['step_peak_above_allocated']}")
    check(held["dots"] > held["block"]
          and 1 / PEAK_MATCH <= row["dots_held_over_block_ratio"] <= PEAK_MATCH,
          f"bytes held for the backward, counted {held}, dots over block measured "
          f"{dots_row['held_over_block']}")
    check(all(1 / PEAK_MATCH <= r <= PEAK_MATCH
              for r in row["loss_and_grad_peak_ratio"].values()),
          f"loss and gradient peaks, counted {grad_peak}, measured {measured_grad_peak}")
    check(nums["flops"] >= mf and nums["coll"]["total"] == 0,
          f"counted {nums['flops']} FLOPs against the model's {mf}, "
          f"collectives {nums['coll']}")
    emit({"phase": "roofline", **row})
    return row


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import kernel as cs_kernel
    from repro_torch.kernels.checksum import ops as cs_ops
    from repro_torch.kernels.checksum import ref as cs_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.selective_scan import kernel as scan1_kernel
    from repro_torch.kernels.selective_scan import ref as scan1_ref
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi[:1],
          "peak_bytes_per_s": PEAK_BYTES_PER_S, "peak_bf16_flops": PEAK_BF16_FLOPS,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    for path in (path for group in GLOO_TESTS for path in group):
        if not os.path.exists(os.path.join(ROOT, path)):
            print(f"chip_smoke: no {path} beside {__file__}", file=sys.stderr)
            return 2
    dryrun_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    gloo_dir = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    perf_dir = tempfile.mkdtemp(prefix="chip_smoke_perf_iter_")
    t_dryrun = time.perf_counter()
    dryrun = start_dryrun(dryrun_dir)
    gloo = start_sharded_gloo(gloo_dir)
    perf_iter = start_perf_iter(perf_dir)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:  # one nvcc per source
        logs = dict(zip(_build.SOURCES, pool.map(_build.build, _build.SOURCES)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if any(w in ln for w in ("entry function", "registers", "spill",
                                                   "arning"))]
                    for src, log in logs.items()}})
    cfg = serve.get_config(ARCH)
    largest_leaf = ("largest training leaf, opt/m/lm_head/w", (cfg.d_model, cfg.vocab_size),
                    torch.float32)
    kernels = (fa_kernel, cs_kernel, ssm_kernel)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_moe_ckpt_")  # train_moe -> serve_sharded
    try:
        worst, bwd_worst = kernel_check(torch, fa_kernel, fa_ref, device)
        cs_worst = checksum_check(torch, cs_ops, cs_ref, device)
        ssm_worst = ssm_check(torch, ssm_ops, ssm_kernel, ssm_ref, device)
        scan1_worst = selective_scan_check(torch, scan1_kernel, scan1_ref, device)
        times = kernel_times(torch, fa_kernel, fa_ref, F, device)
        bwd_times = backward_times(torch, fa_kernel, device)
        cs_times = checksum_times(torch, cs_kernel, cs_ref, device, largest_leaf)
        s_times = ssm_times(torch, ssm_kernel, ssm_ref, device)
        scan1_times = selective_scan_times(torch, scan1_kernel, scan1_ref, device)
        _, serve_fa, serve_sync, accum_row = serve_full_width(
            torch, serve, build, fa_kernel, cs_kernel, ssm_kernel, device, accum=True)
        rwkv_rows, rwkv_ssm = serve_rwkv(torch, serve, build, kernels, ssm_ops, ssm_ref, device)
        _, moe_fa, moe_sync = serve_moe(torch, serve, build, kernels, device)
        _, mamba_times, mamba_ssm, mamba_worst = mamba_layer(torch, kernels, ssm_ops, ssm_ref,
                                                             device)
        ssm_worst = max(ssm_worst, mamba_worst)
        _, hybrid = serve_hybrid(torch, serve, build, kernels, ssm_ops, ssm_ref, device)
        _, jamba2_scan, jamba2_fa, jamba2_sync = serve_jamba2(torch, kernels, scan1_kernel,
                                                              device)
        _, whisper_fa, whisper_sync = serve_whisper(torch, serve, build, kernels, device)
        _, vlm_fa, vlm_sync, _ = serve_full_width(torch, serve, build, fa_kernel, cs_kernel,
                                                  ssm_kernel, device, arch=VLM_ARCH,
                                                  workloads=LLAVA_WORKLOADS, phase="serve_vlm")
        train_fa, train_bwd, train_cs, mirror_cs, train_sync = train_full_width(
            torch, launch_train, fa_kernel, cs_kernel, ssm_kernel, device)
        torch.cuda.empty_cache()
        rwkv_train_ssm, rwkv_train_sync, _ = train_rwkv(
            torch, launch_train, kernels, ssm_ops, ssm_ref, device)
        torch.cuda.empty_cache()
        (moe_train_fa, moe_train_bwd, moe_train_sync, moe_train_cs, trained, moe_row, dots_fa,
         dots_bwd, dots_row) = train_moe(torch, launch_train, kernels, ckpt_dir, device)
        torch.cuda.empty_cache()
        _, sharded = serve_sharded(torch, kernels, ckpt_dir, trained, device)
        fed = federate(torch, kernels, ckpt_dir, trained, device, smi[:1])
        del trained
        sharded_gloo_phase(gloo, gloo_dir, t_dryrun, torch.__version__)
        dryrun_phase(dryrun, dryrun_dir, t_dryrun, torch.__version__)
        perf_iter_phase(perf_iter, perf_dir, t_dryrun, torch.__version__)
        roofline_phase(torch, moe_row, dots_row)
    except SmokeFailure as exc:
        emit({"ok": False, "error": str(exc)})
        return 1
    finally:
        for proc in (dryrun, *gloo, perf_iter):
            stop(proc)
        for path in (ckpt_dir, dryrun_dir, gloo_dir, perf_dir):
            shutil.rmtree(path, ignore_errors=True)
    keys = ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    sync_by_run = {"serve": serve_sync,
                   "serve_rwkv": sum(r["flash_mma_sync_launches"] for r in rwkv_rows),
                   "serve_moe": moe_sync, "serve_jamba2": jamba2_sync,
                   "serve_whisper": whisper_sync, "serve_vlm": vlm_sync,
                   **train_sync, "train_rwkv": rwkv_train_sync, "train_moe": moe_train_sync,
                   "serve_sharded": sharded["sync"]}
    fa_by_path = {"serve": serve_fa, "serve_accum_bf16": accum_row["flash_launches"],
                  "serve_rwkv": 0, "serve_moe": moe_fa, "mamba_layer": 0,
                  "serve_hybrid": hybrid["flash"], "serve_jamba2": jamba2_fa,
                  "serve_whisper": whisper_fa,
                  "serve_vlm": vlm_fa, "train": train_fa, "train_rwkv": 0,
                  "train_moe": moe_train_fa, "train_moe_dots": dots_fa,
                  "serve_sharded": sharded["flash"], "federate": 0}
    # the backward kernel's: the bf16 training runs' (serving computes no
    # gradient; rwkv6 has no attention)
    bwd_by_path = {"train": train_bwd, "train_rwkv": 0, "train_moe": moe_train_bwd,
                   "train_moe_dots": dots_bwd}
    # the bf16-accumulating instances' launches (attn_accum_bf16): the
    # mma.sync kernel's in serve_accum_bf16, the fp32 kernel's on no main path
    accum_by_path = {"serve_accum_bf16": {"mma_sync": accum_row["flash_mma_sync_launches"],
                                          "fp32": accum_row["flash_fp32_launches"]}}
    cs_by_path = {"serve": 0, "serve_rwkv": 0, "serve_moe": 0, "mamba_layer": 0,
                  "serve_hybrid": 0, "serve_whisper": 0, "serve_vlm": 0, "train": train_cs,
                  "train_mirror_restore": mirror_cs, "train_rwkv": 0, "train_moe": moe_train_cs,
                  "serve_sharded": sharded["checksum"], "federate": fed["checksum_launches"]}
    ssm_by_path = {"serve": 0, "serve_rwkv": rwkv_ssm, "serve_moe": 0, "mamba_layer": mamba_ssm,
                   "serve_hybrid": hybrid["scan"], "serve_whisper": 0, "serve_vlm": 0,
                   "train": 0, "train_rwkv": rwkv_train_ssm, "train_moe": 0,
                   "serve_sharded": sharded["scan"], "federate": 0}
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "kernel": "attn_fwd_bf16_tma (TMA, wgmma); attn_fwd_f32 on serve_hybrid's and "
                  "serve_sharded's fp32 paths; attn_fwd_bf16_sync<true> (attn_accum_bf16) "
                  "in serve_accum_bf16",
        "launches": sum(fa_by_path.values()), "launches_by_path": fa_by_path,
        # read in each fp32-accumulating run of each main path, checked to be 0
        "mma_sync_path_launches_by_run": sync_by_run,
        "mma_sync_path_launches": sum(sync_by_run.values()),
        "accum_bf16_launches_by_path": accum_by_path,
        "max_abs_err": worst, **{k: times[0][k] for k in keys}, "shapes": times}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/models/layers.py::chunked_attention (its gradient)",
        "kernel": "attn_bwd_prep, attn_bwd_main<1|2> (TMA, wgmma), attn_bwd_dq; the forward's "
                  "attn_fwd_bf16_tma<true> writes the lse",
        "launches": sum(bwd_by_path.values()), "launches_by_path": bwd_by_path,
        "max_abs_err": bwd_worst, **{k: bwd_times[0][k] for k in keys},
        "device_ms": bwd_times[0]["device_ms"], "shapes": bwd_times}, {
        "name": "lanesum32", "route": "cuda",
        "source": "src/repro_torch/kernels/checksum/csrc/checksum.cu",
        "replaces": "src/repro/kernels/checksum/kernel.py:32",
        "launches": sum(cs_by_path.values()), "launches_by_path": cs_by_path,
        "max_abs_err": cs_worst, **{k: cs_times[0][k] for k in keys}, "shapes": cs_times}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:27",
        "launches": sum(ssm_by_path.values()), "launches_by_path": ssm_by_path,
        "max_abs_err": ssm_worst, **{k: s_times[0][k] for k in keys},
        "device_ms": s_times[0]["device_ms"], "shapes": s_times + mamba_times}, {
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
        "replaces": "none: the JAX package has no Mamba-1 mixer",
        "kernel": "selective_scan_fwd_kernel",
        # only the published Jamba's Mamba-1 layers run it
        "launches": jamba2_scan, "launches_by_path": {"serve_jamba2": jamba2_scan},
        "max_abs_err": scan1_worst, **{k: scan1_times[0][k] for k in keys},
        "device_ms": scan1_times[0]["device_ms"], "shapes": scan1_times}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
