"""The one generator of every cell's inputs, from the workload file's
parameters and the run's seed.  The same seed gives the same inputs; two
seeds give the same sizes in other tokens.

* ``train_batch``: step ``k``'s rows of ``seq_len + 1`` token ids drawn
  uniformly from the vocabulary on the device, the tokens and their
  next-token targets; every row of every step differs.  A ``relabelled``
  workload draws them from the one fixed seed and maps them through the
  seed's vocabulary permutation (``params``).
* ``serve_prompts``: batch ``i``'s ``batch`` prompts of ``prompt_len``
  token ids in [2, vocab) (0 and 1 are the pad and end-of-sequence ids).
"""
from __future__ import annotations

import numpy as np
import torch

from .params import FIXED_SEED, derive, vocab_permutation


def train_batch(workload: dict, config: dict, seed: int, step: int,
                device) -> dict:
    relabelled = workload.get("relabelled", False)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(FIXED_SEED if relabelled else seed, "train", step))
    rows = torch.randint(0, config["vocab"],
                         (workload["batch"], workload["seq_len"] + 1),
                         generator=gen, device=device)
    if relabelled:
        rows = vocab_permutation(seed, config["vocab"], device)[rows]
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


def serve_prompts(workload: dict, config: dict, seed: int,
                  index: int) -> list[np.ndarray]:
    rng = np.random.default_rng(derive(seed, "serve", index))
    ids = rng.integers(2, config["vocab"],
                       (workload["batch"], workload["prompt_len"]))
    return list(ids)
