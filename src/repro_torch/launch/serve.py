"""Serving driver: batched prefill + greedy decode over a request queue.
``python -m repro_torch.launch.serve --arch qwen3-0.6b``.

The counterpart of ``repro/launch/serve.py``: a batch of requests is
prefilled, then decoded step by step against the KV cache (updated in
place); when the batch is done its slots go to the next requests in the
queue.  Runs on ``--device cuda`` unless asked otherwise; ``--attn kernel``
sends attention and the SSD through the Hopper kernels, ``--attn plain``
through plain PyTorch; ``--n-layers`` keeps the arch's width and cuts its
depth, for a model whose weights pass one card (command-r-plus-104b's
208 GB in bf16); an MoE arch keeps its leading dense layers, so N must
exceed them.  whisper-base and paligemma-3b take their stub frontend's
output beside each batch (``Model.extra_inputs``), drawn from the prompts'
numpy rng as the reference draws it; paligemma's cache must hold its image
prefix, prompt and new tokens (``--max-len`` at least ``vis_tokens +
prompt_len + max_new``), or serving refuses to start where the reference
would roll the cache silently.  Before serving, as the reference does, this
prints ``launch.layers.layer_report``: the model's block GEMMs at the
decode batch compiled by the Covenant driver against ``--accel-target``
(any name of the port's registry, derived variants included; ``none``
skips it; an unknown name exits 2), with ``--accel-search`` through
schedule search; against ``h100`` on a card each GEMM also runs through
the Covenant-tiled GEMM kernel, timed beside the covenant's prediction.
Started under ``torchrun``, it serves inside the reference's mesh context:
the host mesh over every rank (``launch.mesh``), the weights not placed,
as the reference does not place them, so the tokens are the unsharded
run's.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from .. import configs
from ..core import CompileOptions, SearchOptions
from ..kernels.flash_attention import flash_attention, flash_decode
from ..kernels.matmul import matmul
from ..kernels.ssd_scan import ssd_chunk_scan
from . import mesh as mesh_lib
from .layers import check_accel_target, layer_report
from ..models import Model, get_model

EOS = 1


def serve(model: Model, params: dict, prompts: list, *, batch: int,
          max_new: int, max_len: int, batch_seconds: list | None = None,
          rng: np.random.Generator | None = None
          ) -> tuple[list[np.ndarray], int]:
    """Serve ``prompts`` (equal-length token arrays) greedily, ``batch`` at
    a time, popping from the end of the queue as the reference does.
    Returns the tokens each batch produced ((bs, steps) arrays: the prefill
    token, then one per decode step) and the count of new tokens; appends
    each batch's wall seconds to ``batch_seconds`` when given.  A model
    with ``extra_inputs`` draws them for each batch from ``rng``
    (``extra_inputs`` below), as the reference does from its prompts'
    rng."""
    queue = list(prompts)
    outputs = []
    total_tokens = 0
    while queue:
        t0 = time.perf_counter()
        batch_prompts = [queue.pop() for _ in range(min(batch, len(queue)))]
        bs = len(batch_prompts)
        toks = torch.as_tensor(np.stack(batch_prompts), dtype=torch.long,
                               device=model.device)
        inputs = {"tokens": toks,
                  **extra_inputs(model, bs, toks.shape[1], rng)}
        cache = model.init_cache(bs, max_len)
        logits, cache = model.prefill(params, inputs, cache)
        tok = logits.argmax(-1)
        steps = [tok]
        done = np.zeros(bs, bool)
        for _ in range(max_new):
            logits, cache = model.decode_step(params, tok, cache)
            tok = logits.argmax(-1)
            steps.append(tok)
            total_tokens += int((~done).sum())
            done |= tok.cpu().numpy() == EOS
            if done.all():
                break
        outputs.append(torch.stack(steps, 1).cpu().numpy())
        if batch_seconds is not None:
            batch_seconds.append(time.perf_counter() - t0)
    return outputs, total_tokens


def extra_inputs(model: Model, bs: int, seq: int,
                 rng: np.random.Generator | None) -> dict:
    """The stub frontend's inputs of one batch (``Model.extra_inputs``,
    empty for most families): standard normal draws from ``rng``, cast to
    each spec's dtype on the model's device."""
    return {name: torch.as_tensor(rng.standard_normal(shape_fn(bs, seq)),
                                  dtype=dtype, device=model.device)
            for name, (shape_fn, dtype) in model.extra_inputs.items()}


def kernel_launches() -> dict[str, int]:
    return {"matmul": matmul.launches,
            "flash_attention": flash_attention.launches,
            "flash_decode": flash_decode.launches,
            "ssd_chunk_scan": ssd_chunk_scan.launches}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="serve this many layers at full width (0: all)")
    ap.add_argument("--accel-target", default="h100",
                    help="Covenant target of the layer-compile report: any "
                         "name of the port's registry, derived variants "
                         "like 'dnnweaver@pe=32x32' included ('none' skips "
                         "it)")
    ap.add_argument("--accel-search", action="store_true",
                    help="schedule-search the layer compiles "
                         "(CompileOptions(search=...))")
    args = ap.parse_args(argv)
    check_accel_target(ap, args.accel_target)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if args.n_layers:
        if args.n_layers <= cfg.first_dense:
            ap.error(f"--n-layers must exceed {cfg.name}'s "
                     f"{cfg.first_dense} leading dense layers")
        cfg = cfg.replace(n_layers=args.n_layers)
    stream = cfg.vis_tokens + args.prompt_len + args.max_new
    if cfg.family == "vlm" and args.max_len < stream:
        ap.error(f"{cfg.name} needs --max-len {stream} or more (image "
                 f"prefix {cfg.vis_tokens} + prompt {args.prompt_len} + "
                 f"new tokens {args.max_new}); got {args.max_len}")
    before = kernel_launches()
    if args.accel_target != "none":
        opts = CompileOptions(
            search=SearchOptions(generations=3, population=8)
            if args.accel_search else None)
        print(layer_report(cfg, tokens=args.batch, target=args.accel_target,
                           options=opts, device=args.device,
                           seed=args.seed))
    model = get_model(cfg, device=args.device, attn=args.attn)
    params = model.init_params(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(2, cfg.vocab, args.prompt_len)
               for _ in range(args.requests)]
    per_batch: list[float] = []
    ctx = contextlib.nullcontext()
    if mesh_lib.launched():
        mesh_lib.init_distributed(args.device)
        mesh = mesh_lib.make_host_mesh(
            device_type=torch.device(args.device).type)
        ctx = mesh_lib.use_mesh(mesh)
        print(f"[serve] on the host mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    t0 = time.perf_counter()
    with ctx:
        outputs, total_tokens = serve(model, params, prompts,
                                      batch=args.batch, max_new=args.max_new,
                                      max_len=args.max_len,
                                      batch_seconds=per_batch, rng=rng)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    print(f"[serve] {cfg.name} on {args.device} (attn={args.attn}): "
          f"{len(prompts)} requests, {total_tokens} new tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s); per batch "
          + ", ".join(f"{b:.3f}s" for b in per_batch))
    print("[serve] kernel launches: " +
          " ".join(f"{k}={v}" for k, v in launches.items()))
    return {"requests": len(prompts), "new_tokens": total_tokens,
            "seconds": dt, "tok_per_s": total_tokens / dt,
            "batch_seconds": per_batch, "launches": launches,
            "n_layers": cfg.n_layers,
            "batches": len(outputs), "outputs": outputs,
            "decode_steps": sum(o.shape[1] - 1 for o in outputs)}


if __name__ == "__main__":
    main()
