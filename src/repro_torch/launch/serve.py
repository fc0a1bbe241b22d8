"""Serving launcher: batched prefill + greedy decode.

``python -m repro_torch.launch.serve --arch h2o-danube-3-4b --requests 4``
serves a scaled-down model on the card; ``--no-scaled-down`` serves the
full-width config, ``--device cpu`` runs on the CPU.  Every arch id
serves.  Weights and prompts are random, drawn from ``torch.Generator``s
seeded with ``--seed`` and ``--seed + 1``: after the tokens, whisper's
requests draw ``n_audio_ctx`` frames of audio embeddings and llava's
``n_image_tokens`` image patch embeddings, fp32 normals, as the
reference's launcher does (its prompts begin with those image positions).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models.registry import build
from ..runtime.steps import make_prefill_step, make_serve_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--scaled-down", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(api, params, prefill batch) for ``args``: the batch holds the prompt
    ``tokens`` (B, S) and, for whisper, ``audio_embeds`` (B, n_audio_ctx,
    d_model) or, for llava, ``image_embeds`` (B, n_image_tokens, patch_dim)."""
    cfg = get_config(args.arch)
    if args.scaled_down:
        cfg = cfg.scaled_down()
    api = build(cfg, args.device)
    params = api.init(torch.Generator(api.device).manual_seed(args.seed))
    gen = torch.Generator(api.device).manual_seed(args.seed + 1)
    B = args.requests
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                                     generator=gen, device=api.device)}
    if cfg.is_encdec:
        batch["audio_embeds"] = torch.randn((B, cfg.encdec.n_audio_ctx, cfg.d_model),
                                            generator=gen, device=api.device)
    if cfg.vlm is not None:
        batch["image_embeds"] = torch.randn((B, cfg.vlm.n_image_tokens, cfg.vlm.patch_dim),
                                            generator=gen, device=api.device)
    return api, params, batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(api, params, batch, gen_len: int) -> dict:
    """Prefills ``batch`` (its ``tokens`` and any audio or image embeddings)
    then decodes greedily to ``gen_len`` tokens per request (the first from
    the prefill logits).  Returns the prefill logits, the generated tokens
    (B, gen_len) and host wall times taken around a device synchronise;
    ``prefill_tok_s`` counts prompt tokens."""
    B, S = batch["tokens"].shape
    prefill_step = make_prefill_step(api, pad_to=S + gen_len)
    serve_step = make_serve_step(api)
    _sync(api.device)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(api.device)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(gen_len - 1):
        tok, cache = serve_step(params, cache, tok, S + i)
        out.append(tok)
    _sync(api.device)
    t2 = time.perf_counter()
    return {"logits": logits, "tokens": torch.cat(out, dim=1),
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "prefill_tok_s": B * S / (t1 - t0),
            "decode_tok_s": B * (gen_len - 1) / (t2 - t1) if gen_len > 1
            else None}


def main(argv=None) -> dict:
    args = parse_args(argv)
    api, params, batch = setup(args)
    res = serve(api, params, batch, args.gen_len)
    B, S = batch["tokens"].shape
    print(f"{api.cfg.arch_id} on {api.device}: prefill {B}x{S} in "
          f"{res['prefill_s']:.3f}s ({res['prefill_tok_s']:.1f} tok/s)")
    if res["decode_tok_s"] is not None:
        print(f"decoded {args.gen_len - 1} steps x {B} seqs in "
              f"{res['decode_s']:.3f}s ({res['decode_tok_s']:.1f} tok/s)")
    print("sample token ids:", res["tokens"][0, :12].tolist())
    return res


if __name__ == "__main__":
    main()
