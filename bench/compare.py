"""The numbers that decide ``correct``: what the timed path produced,
held against the plain reference's, each beside its limit.

Training (``train_numbers``), per the first three steps; a leaf's gap is
the gap between its norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf:
  * ``loss_gap``: the largest |loss - reference loss| / |reference loss|;
  * ``grad_gap``: the worst leaf's gap of the first (clipped) gradient as
    the optimizer got it;
  * ``grad_gap_mean``: the mean over the leaves of that gap;
  * ``final_norm_grad_gap``: that gap of the final norm's scale, the leaf
    every token's logit gradient reaches first;
  * ``change_gap``: the worst leaf's gap of its change over the three
    steps, leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's (round-off alone moves them).
A workload file's ``limits`` name the numbers that decide ``correct``;
the others are printed beside them.
Serving (``serve_numbers``), over a sample of served requests:
  * ``token_gap``: the widest gap by which a served token's reference
    logit lies below the reference's best at its position;
  * ``logit_err``: the largest relative L2 distance, over the sampled
    positions, of the logits the timed path returned from the
    reference's.
"""
from __future__ import annotations

import math
import statistics

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone and is left out of the change
QUIET_LEAF = 1e-3


def _leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
            if math.isfinite(got[k]) else math.inf for k in names}


def _worst(gaps: dict) -> tuple[float, str]:
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def train_numbers(got: dict, ref: dict, final_norm: str) -> dict:
    """``got`` and ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}; ``final_norm`` the final norm's leaf.
    Returns {number: (value, where)}."""
    loss = max((abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
                else math.inf) for a, b in zip(got["losses"], ref["losses"]))
    grads = _leaf_gaps(got["grad_norms"], ref["grad_norms"])
    gmed = statistics.median(ref["grad_norms"].values())
    moving = {k for k, v in ref["grad_norms"].items()
              if v >= QUIET_LEAF * gmed}
    return {"loss_gap": (loss, "steps 1-3"),
            "grad_gap": _worst(grads),
            "grad_gap_mean": (statistics.fmean(grads.values()),
                              f"{len(grads)} leaves"),
            "final_norm_grad_gap": (grads[final_norm], final_norm),
            "change_gap": _worst(_leaf_gaps(got["change_norms"],
                                            ref["change_norms"], moving))}


def serve_numbers(served, logits, ref_logits) -> dict:
    """``served`` (N, T) int tokens, ``logits`` (N, T, V) the timed path's,
    ``ref_logits`` (N, T, V) the reference's at the same positions.
    Returns {number: (value, where)}."""
    import torch

    picked = torch.gather(ref_logits, -1, served[..., None].long())[..., 0]
    gaps = ref_logits.amax(-1) - picked
    n, t = divmod(int(gaps.argmax()), gaps.shape[1])
    out = {"token_gap": (float(gaps.max()), f"request {n} token {t}")}
    err = (logits.float() - ref_logits).norm(dim=-1) / ref_logits.norm(dim=-1)
    if not bool(torch.isfinite(logits).all()):
        err = torch.full_like(err, math.inf)
    n, t = divmod(int(err.argmax()), err.shape[1])
    out["logit_err"] = (float(err.max()), f"request {n} token {t}")
    return out


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit within it, {number: {"value",
    "limit", "where"}} of those numbers)."""
    out, ok = {}, True
    for name, limit in limits.items():
        value, where = numbers[name]
        ok = ok and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "where": where}
    return ok, out
