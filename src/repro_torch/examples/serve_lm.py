"""Batched serving example: continuous-batching decode loop against a
smoke-size gemma3 (sliding-window KV caches exercised).

Layer compilation runs on the Covenant compile driver: the serving stack
compiles the model's decode-shape GEMMs with ``repro_torch.compile`` (see
``repro_torch/launch/layers.py``) and prints the accelerator cycle report
before serving.  Set ``REPRO_TORCH_CACHE_DIR`` to replay those compiles
from the disk artifact store on relaunch.  Attention and decode run
through the Hopper flash kernels on ``--device cuda`` (the default); on
``--device cpu`` through their plain versions.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The port's copy of ``examples/serve_lm.py``.
"""
import argparse

from repro_torch.launch import serve

ARGS = ["--arch", "gemma3-12b", "--smoke", "--requests", "8", "--batch", "4",
        "--max-new", "16", "--accel-target", "hvx"]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve.main([*ARGS, "--device", args.device])


if __name__ == "__main__":
    main()
