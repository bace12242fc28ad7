"""Batched decode serving entry point of the port.

Random-inits a model on the device (or restores a checkpoint), ingests a
batch of random prompts through the decode path with a KV/SSM cache, then
generates, reporting tokens/s:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \\
        --smoke --batch 4 --context 64 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Counterpart of ``repro.launch.serve``, with its flags and its three lines
of output (prefill tok/s per sequence, decode tok/s aggregate, sample ids)
plus ``--device``: the CUDA device by default, ``cpu`` on request, never a
fallback.  Params come from the zoo's init on a ``torch.Generator`` seeded
with ``--seed``, or from the newest checkpoint under ``--ckpt-dir`` in the
reference's format (either package's).  The prompts are ``torch.randint``
draws, and sampling (``--temperature`` > 0) draws with the reference's
threefry key ``PRNGKey(seed)``, split once per token.  The audio family
(whisper) draws N(0, 1) frame embeddings (B, T, d_model) in bf16 on the
device, as the reference draws its stub front end's output, and builds the
cache from them (the encoder runs once); its decoder then ingests and
generates text as the others do.  The vision family is refused, as the
reference refuses it.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.threefry import PRNGKey, categorical_t, split_t
from repro_torch.device import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.train import latest_step, restore_checkpoint

__all__ = ["main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend is not None and cfg.family != "audio":
        raise SystemExit("serve.py drives text decoders")
    device = resolve_device(args.device)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    if args.ckpt_dir:
        step = latest_step(args.ckpt_dir)
        if step is not None:
            params = restore_checkpoint(args.ckpt_dir, step, params)
            print(f"restored checkpoint step {step}")

    max_seq = args.context + args.new_tokens
    b = args.batch
    if cfg.family == "audio":
        frames = torch.randn((b, cfg.num_frontend_tokens, cfg.d_model),
                             generator=gen, device=device).to(torch.bfloat16)
        cache = model.init_cache(params, frames, b, max_seq)
    else:
        cache = model.init_cache(params, b, max_seq)
    prompt = torch.randint(0, cfg.vocab_size, (b, args.context),
                           generator=gen, device=device)
    key = torch.from_numpy(PRNGKey(args.seed).astype("int64")).to(device)
    temperature = torch.tensor(args.temperature, dtype=torch.float32,
                               device=device)

    with torch.no_grad():
        # prefill via sequential decode (teacher-forced context ingestion)
        _sync(device)
        t0 = time.perf_counter()
        logits = None
        for t in range(args.context):
            logits, cache = model.decode_step(params, prompt[:, t:t + 1],
                                              cache, t)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        # autoregressive generation
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        outs = [tok]
        t0 = time.perf_counter()
        for t in range(args.context, max_seq - 1):
            logits, cache = model.decode_step(params, tok, cache, t)
            if args.temperature > 0:
                key, sub = split_t(key)
                tok = categorical_t(sub, logits[:, -1] / temperature
                                    )[:, None]
            else:
                tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            outs.append(tok)
        _sync(device)
        t_gen = time.perf_counter() - t0
    gen_ids = torch.cat(outs, dim=1).cpu()
    n_new = gen_ids.shape[1]
    print(f"arch={cfg.name} batch={b} context={args.context}")
    print(f"prefill: {args.context / max(t_prefill, 1e-9):.1f} tok/s/seq")
    print(f"decode:  {b * n_new / max(t_gen, 1e-9):.1f} tok/s aggregate "
          f"({n_new} new tokens/seq)")
    print("sample token ids:", gen_ids[0, :16].tolist())


if __name__ == "__main__":
    main()
