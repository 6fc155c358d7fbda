"""Input stand-ins + sharding assignments for every (arch x shape) dry-run
cell.

The counterpart of ``repro/launch/specs.py``.  Where the reference builds
``jax.ShapeDtypeStruct`` stand-ins, the port builds tensors under the
caller's ``FakeTensorMode`` (shape and dtype, no storage), so every
function here that makes a stand-in runs inside one.  The shardings are
``runtime.sharding.NamedSharding``s on a ``DeviceMesh`` (or on a mesh stub
with a ``shape`` dict, for the specs alone):

* params & optimizer moments: rule engine (runtime/sharding.py) — tensor
  axes over ``model``, ZeRO weight shard over ``data``;
* batch dims over ``(pod, data)``;
* KV caches: batch over data; sequence over ``model`` when kv_heads can't
  fill it, else kv-heads over ``model``; SSM states: heads over ``model``.
"""
from __future__ import annotations

import torch

from .. import configs
from ..models import get_model
from ..optim import adamw
from ..runtime import sharding as shard_rules
from ..runtime.sharding import NamedSharding, P, divisible
from ..tree import tree_map, tree_map_with_path


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data")
                 if a in shard_rules.axis_sizes(mesh))


def activation_axes(cfg, mesh) -> tuple:
    """The (batch, seq, heads, vocab) axes of
    ``configure_activation_sharding`` that the reference's dry-run picks:
    the batch over pod and data, the sequence over model, heads and vocab
    over model where model divides them."""
    model = shard_rules.axis_sizes(mesh)["model"]
    heads = "model" if cfg.n_heads and cfg.n_heads % model == 0 else None
    vocab = "model" if cfg.vocab % model == 0 else None
    return _batch_axes(mesh), "model", heads, vocab


def train_batch_specs(cfg, shape: configs.ShapeSpec, model) -> dict:
    seq = shape.seq_len
    if cfg.family == "vlm":
        seq = shape.seq_len - cfg.vis_tokens  # image prefix fills the rest
    bs = shape.global_batch
    specs = {"tokens": torch.zeros((bs, seq), dtype=torch.int32),
             "targets": torch.zeros((bs, seq), dtype=torch.int32),
             "weights": torch.zeros((bs, seq), dtype=torch.float32)}
    for name, (shape_fn, dtype) in model.extra_inputs.items():
        specs[name] = torch.zeros(shape_fn(bs, seq), dtype=dtype)
    return specs


def serve_specs(cfg, shape: configs.ShapeSpec, model):
    """(prefill batch specs, decode token specs, cache specs)."""
    bs = shape.global_batch
    cache = model.init_cache(bs, shape.seq_len)
    seq = shape.seq_len - (cfg.vis_tokens if cfg.family == "vlm" else 0)
    prefill_batch = {"tokens": torch.zeros((bs, seq), dtype=torch.int32)}
    for name, (shape_fn, dtype) in model.extra_inputs.items():
        prefill_batch[name] = torch.zeros(shape_fn(bs, shape.seq_len),
                                          dtype=dtype)
    tokens = torch.zeros((bs,), dtype=torch.int32)
    return prefill_batch, tokens, cache


# ---------------------------------------------------------------------------
# cache sharding
# ---------------------------------------------------------------------------


def _divisible(dim: int, mesh, axes) -> bool:
    return axes is not None and divisible(dim, mesh, axes)


def cache_spec_for(path: str, shape: tuple, cfg, mesh) -> P:
    batch = _batch_axes(mesh)
    batch = batch if len(batch) != 1 else batch[0]

    def b_if(dim):  # batch axes if they divide, else replicate
        return batch if _divisible(dim, mesh, batch) else None

    if path.endswith("length"):
        return P(b_if(shape[0]))
    if "conv" in path:                       # (..., B, w-1, conv_ch)
        lead = len(shape) - 3
        return P(*([None] * lead), b_if(shape[-3]), None,
                 "model" if _divisible(shape[-1], mesh, "model") else None)
    if "ssm" in path:                        # (..., B, H, N, Pdim)
        lead = len(shape) - 4
        return P(*([None] * lead), b_if(shape[-4]),
                 "model" if _divisible(shape[-3], mesh, "model") else None,
                 None, None)
    if path.endswith("/k") or path.endswith("/v") or path in ("k", "v"):
        # (..., B, Hkv, S, hd): prefer kv-heads on model; else sequence
        lead = len(shape) - 4
        bdim, hdim, sdim = shape[-4], shape[-3], shape[-2]
        if _divisible(hdim, mesh, "model"):
            spec = (b_if(bdim), "model", None, None)
        elif _divisible(sdim, mesh, "model"):
            spec = (b_if(bdim), None, "model", None)
        else:
            spec = (b_if(bdim), None, None, None)
        return P(*([None] * lead), *spec)
    return P()


def cache_shardings(cache_tree, cfg, mesh):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, cache_spec_for(
            shard_rules._path_str(path), tuple(leaf.shape), cfg, mesh)),
        cache_tree)


# ---------------------------------------------------------------------------
# full cell assembly
# ---------------------------------------------------------------------------


def make_optimizer():
    return adamw(1e-4)


def cell_abstract(arch: str, shape_name: str, overrides: dict | None = None):
    """(cfg, model, shape); ``overrides`` are ArchConfig.replace kwargs.
    The model runs on the CPU's fake tensors, on the plain attention path,
    as the reference's models take ``dense_attention``."""
    cfg = configs.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = configs.SHAPES[shape_name]
    model = get_model(cfg, device="cpu", attn="plain")
    return cfg, model, shape


def infer_param_shardings(p_sh):
    """Inference sharding: drop the ZeRO ``data`` axis from every param
    spec (weights replicated across data-parallel ranks).  Serving reads
    weights every step — re-gathering them per token is pure waste; the
    per-device HBM cost (params/|model|) is the explicit trade."""
    def fix(ns):
        spec = tuple(None if ax in ("data", ("data",)) else
                     (tuple(a for a in ax if a != "data") or None
                      if isinstance(ax, tuple) else ax)
                     for ax in tuple(ns.spec))
        return NamedSharding(ns.mesh, P(*spec))
    return tree_map(fix, p_sh)


def train_cell(arch: str, shape_name: str, mesh, microbatches: int = 4,
               overrides: dict | None = None):
    """Everything needed to run a train step: (fn, (params, opt state,
    batch) stand-ins, their shardings, the outputs' shardings)."""
    from ..runtime import make_train_step

    cfg, model, shape = cell_abstract(arch, shape_name, overrides)
    opt = make_optimizer()
    params = model.init_params(0)
    opt_state = opt.init(params)
    batch = train_batch_specs(cfg, shape, model)

    p_sh = shard_rules.shardings(params, mesh)
    o_sh = shard_rules.shardings(opt_state, mesh)
    b_sh = shard_rules.batch_shardings(batch, mesh)
    step = make_train_step(model.loss_fn, opt, microbatches=microbatches,
                           grad_shardings=p_sh)
    rep = shard_rules.replicated(mesh)
    metrics_sh = {"loss": rep, "grad_norm": rep, "lr": rep}
    return (step, (params, opt_state, batch),
            (p_sh, o_sh, b_sh), (p_sh, o_sh, metrics_sh))


def serve_auto_policy(cfg, shape) -> bool:
    """True -> keep ZeRO (data-sharded) weights for serving: the
    reference's measured policy (dense decode at batch >= 16 wins with
    weights replicated over data; MoE, SSM decode and tiny batches or
    models win with them data-sharded)."""
    return (cfg.family in ("moe", "ssm") or shape.global_batch < 16
            or cfg.d_model <= 1024)


def serve_cell(arch: str, shape_name: str, mesh, kind: str,
               overrides: dict | None = None,
               zero_params: bool | None = None):
    """kind in {prefill, decode}: (fn, args, in shardings, out shardings).
    ``zero_params``: True = ZeRO sharding, False = inference (replicated
    over data), None = the auto policy."""
    cfg, model, shape = cell_abstract(arch, shape_name, overrides)
    if zero_params is None:
        zero_params = serve_auto_policy(cfg, shape)
    params = model.init_params(0)
    p_sh = shard_rules.shardings(params, mesh)
    if not zero_params:
        p_sh = infer_param_shardings(p_sh)
    pre_batch, tokens, cache = serve_specs(cfg, shape, model)
    c_sh = cache_shardings(cache, cfg, mesh)
    vocab_ax = "model" if _divisible(cfg.vocab, mesh, "model") else None
    batch_ax = _squash(_batch_axes(mesh)) \
        if _divisible(shape.global_batch, mesh, _batch_axes(mesh)) else None
    logits_sh = NamedSharding(mesh, P(batch_ax, vocab_ax))

    if kind == "prefill":
        b_sh = shard_rules.batch_shardings(pre_batch, mesh)

        def fn(params, batch, cache):
            return model.prefill(params, batch, cache)

        return fn, (params, pre_batch, cache), \
            (p_sh, b_sh, c_sh), (logits_sh, c_sh)

    tok_sh = NamedSharding(mesh, P(batch_ax))

    def fn(params, tokens, cache):
        return model.decode_step(params, tokens, cache)

    return fn, (params, tokens, cache), \
        (p_sh, tok_sh, c_sh), (logits_sh, c_sh)


def _squash(axes: tuple):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


__all__ = ["activation_axes", "cache_shardings", "cache_spec_for", "cell_abstract",
           "infer_param_shardings", "make_optimizer", "serve_auto_policy",
           "serve_cell", "serve_specs", "train_batch_specs", "train_cell"]
