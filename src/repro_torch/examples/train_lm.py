"""End-to-end driver: train a ~100M-param qwen3-family model on the
synthetic LM stream for a few hundred steps with the production stack
(train step with microbatch accumulation, checkpoints, fault tolerance).

Layer compilation runs through the Covenant compile driver first: the
step's GEMMs are compiled with ``repro_torch.compile``
(``repro_torch/launch/layers.py``) and the accelerator cycle report
printed; with ``REPRO_TORCH_CACHE_DIR`` set, relaunches replay the
compiles from the disk artifact store.  Attention forward and backward
run through the Hopper flash kernels on ``--device cuda`` (the default).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]

The port's copy of ``examples/train_lm.py``: it trains inside the host
mesh (``make_host_mesh`` / ``use_mesh``), as the reference does, over
every rank of the process group (``launch.mesh.init_distributed``: the
``torchrun`` ranks, or one); the params are not placed, as the
reference's are not.  The parameter count is ``roofline.param_count``'s,
as the reference's example takes it.
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.kernels import kernel_launches
from repro_torch.launch.layers import layer_report
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     use_mesh)
from repro_torch.models import get_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.roofline import param_count
from repro_torch.runtime import make_train_step, train_loop

MICROBATCHES = 2
SEQ_LEN = 256
GLOBAL_BATCH = 8


def config():
    """~100M params: qwen3 family, scaled width and depth, in f32."""
    return configs.get_config("qwen3-0.6b").replace(
        n_layers=10, d_model=768, n_heads=12, n_kv_heads=6, d_ff=3072,
        vocab=32768, head_dim=64, param_dtype="float32",
        compute_dtype="float32", remat=False)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--accel-target", default="hvx")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config()
    model = get_model(cfg, device=args.device)
    params = model.init_params(0)
    total, _ = param_count(cfg)
    print(f"[train_lm] {total / 1e6:.1f}M params")
    # per-GEMM accelerator cycles at the training token count (8 x 256),
    # compiled through the driver's pipeline/cache/store seam
    print(layer_report(cfg, tokens=GLOBAL_BATCH * SEQ_LEN,
                       target=args.accel_target, device=args.device))

    before = kernel_launches()
    init_distributed(args.device)
    mesh = make_host_mesh(device_type=torch.device(args.device).type)
    with use_mesh(mesh):
        opt = adamw(cosine_schedule(1e-3, 30, args.steps))
        opt_state = opt.init(params)
        step = make_train_step(model.loss_fn, opt,
                               microbatches=MICROBATCHES)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ_LEN,
                           global_batch=GLOBAL_BATCH, seed=0)
        params, opt_state, rep = train_loop(
            step, params, opt_state, data.batch, cfg=cfg, steps=args.steps,
            ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=25)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    steady = rep.step_seconds[1:] or rep.step_seconds
    print(f"[train_lm] {1e3 * sum(steady) / len(steady):.1f} ms per step "
          f"after the first on {args.device}")
    print("[train_lm] kernel launches: " +
          " ".join(f"{k}={v}" for k, v in launches.items()))
    print("[train_lm] losses: " + " ".join(f"{x:.4f}" for x in rep.losses))
    print(f"[train_lm] loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}")
    assert rep.losses[-1] < rep.losses[0]
    return {"report": rep, "launches": launches, "params": total}


if __name__ == "__main__":
    main()
