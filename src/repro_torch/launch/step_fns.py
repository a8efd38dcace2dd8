"""Step-function builders for LM training and serving on a mesh of slots.

Every builder returns a :class:`BuiltStep`: the step function, its
arguments as meta-device stand-ins (``abstract_args``: parameters,
optimizer state and caches from ParamMeta trees, inputs from
``configs.input_specs``; nothing is allocated), their shardings, the
model and a few facts about the step.

The mesh is ``launch/mesh.py``'s: one process drives every slot, so no
``torch.distributed``.  The training step splits work the way the
reference's sharded step does, and its values are the single-device
step's:

  * each parameter and each optimizer moment is stored in pieces, split
    along the dims its spec names (``params.best_spec``: over "model"
    and "data" alike), one piece per slot of the axes named there; a
    step gathers each leaf onto every data slot's device to compute;
  * each data slot runs forward and backward on its share of the batch
    (``input_shardings``); the loss is the global mean over valid
    tokens, the slots' summed log-likelihoods over the global count of
    labels >= 0; the gathers' backward sums each gradient onto the
    pieces, where AdamW updates them.  A routed (MoE) arch computes the
    batch whole on the first data slot: its capacity and ranks are those
    of every token of the batch, as in the reference;
  * ``n_micro`` microbatches go through ``GradAccumulator`` (the mean
    of the microbatches' losses and gradients, the reference's
    semantics).

With every slot on one device (``make_host_mesh(..., device=)``) the
pieces are copies; a gather of a leaf stored in one piece copies
nothing, so on a 1x1 mesh the gathered parameters are the stored pieces
themselves, which is sound because the update is out of place (it
builds new pieces and never writes into the old).  The serving steps run on the mesh's
first slot with whole parameters (pieces are gathered there).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, input_specs
from repro_torch.core import bfp as bfp_lib
from repro_torch.core import tree as tree_lib
from repro_torch.models.lm import LMModel, token_nll
from repro_torch.models.lm import params as params_lib
from repro_torch.optim import (OptState, adamw, clip_by_global_norm,
                               cosine_with_warmup)
from repro_torch.optim.grad_utils import GradAccumulator
from repro_torch.runtime import sharding as shd

F32 = torch.float32


def default_moment_dtype(cfg: ArchConfig) -> str:
    n = cfg.param_count()
    if n > 100e9:
        return "bfp8"        # kimi/grok class
    if n > 10e9:
        return "bfloat16"
    return "float32"


def _is_bfp(x) -> bool:
    return isinstance(x, bfp_lib.BFPTensor)


def opt_state_shardings(metas, mesh, moment_dtype: str, opt_init):
    """``(abstract optimizer state, its shardings)``: the moments follow
    the parameters; a BFP moment's exponent keeps the axes that divide
    its block count (``params.exponent_spec``)."""
    abstract_opt = opt_init(params_lib.abstract(metas))
    param_sh = tree_lib.leaves(params_lib.shardings(metas, mesh))

    def moment_shardings(abstract_m):
        out = []
        for leaf, sh in zip(tree_lib.leaves(abstract_m, is_leaf=_is_bfp),
                            param_sh, strict=True):
            if _is_bfp(leaf):
                ndim = leaf.mantissa.dim()
                mspec = tuple(sh.spec) + (None,) * (ndim - len(sh.spec))
                espec = params_lib.exponent_spec(
                    sh.spec, ndim, leaf.exponent.shape[-1], mesh)
                out.append(dataclasses.replace(
                    leaf, mantissa=shd.Sharding(mesh, mspec),
                    exponent=shd.Sharding(mesh, espec)))
            else:
                out.append(sh)
        return tree_lib.unflatten(abstract_m, out, is_leaf=_is_bfp)

    return abstract_opt, OptState(shd.replicated(mesh),
                                  moment_shardings(abstract_opt.mu),
                                  moment_shardings(abstract_opt.nu), None)


@dataclasses.dataclass
class BuiltStep:
    fn: Any                     # the step function
    abstract_args: Tuple        # its positional arguments, meta tensors
    arg_shardings: Tuple
    model: LMModel
    meta: Dict[str, Any]


def _first_device(mesh) -> torch.device:
    return mesh.devices.flat[0]


def _check_bfp_moments(metas, mesh, moment_dtype: str) -> None:
    """A bfp8 moment is quantized piece by piece, in blocks of 32 along
    the last dim: that equals the whole leaf's quantization only when a
    split last dim leaves whole blocks in every piece."""
    if moment_dtype != "bfp8":
        return
    sizes = shd.mesh_axis_sizes(mesh)
    for path, m in params_lib.leaves_with_path(metas):
        spec = params_lib.best_spec(m, sizes)
        if len(spec) == len(m.shape) and shd.entry_axes(spec[-1]):
            n = math.prod(sizes[a] for a in shd.entry_axes(spec[-1]))
            if (m.shape[-1] // n) % 32:
                raise ValueError(
                    f"bfp8 moments: {'.'.join(path)} {m.shape} splits its "
                    f"last dim over {spec[-1]} into pieces that are not "
                    f"whole 32-value blocks")


def _place_opt(opt: OptState, opt_sh: OptState, device) -> OptState:
    return OptState(opt.step.to(device),
                    shd.place_tree(opt.mu, opt_sh.mu),
                    shd.place_tree(opt.nu, opt_sh.nu), opt.extra)


def build_train_step(cfg: ArchConfig, mesh, shape: ShapeConfig, *,
                     moment_dtype: Optional[str] = None,
                     n_micro: int = 1) -> BuiltStep:
    """``fn(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``: one AdamW step (``cosine_with_warmup(3e-4, 2000,
    100_000)``, clipping at 1.0, the reference's defaults).  ``params``
    and ``opt_state`` are whole trees (from ``init_params`` and
    ``opt_init``) or the pieces a previous call returned; the step
    returns pieces (``runtime.sharding.gather_tree`` with
    ``arg_shardings`` puts them back together).  ``meta["value_and_grad"](params, batch)`` is the
    loss and the gradient pieces alone."""
    dev0 = _first_device(mesh)
    model = LMModel(cfg, dev0)
    metas = model.param_meta()
    md = moment_dtype or default_moment_dtype(cfg)
    _check_bfp_moments(metas, mesh, md)
    opt_init, opt_update = adamw(cosine_with_warmup(3e-4, 2000, 100_000),
                                 moment_dtype=md)
    abstract_params = params_lib.abstract(metas)
    param_sh = params_lib.shardings(metas, mesh)
    abstract_opt, opt_sh = opt_state_shardings(metas, mesh, md, opt_init)

    in_specs = input_specs(cfg, shape)
    batch_sh = shd.input_shardings(mesh, in_specs)
    ctx_extra = {"shard": shd.activation_constrainer(mesh,
                                                     shape.global_batch)}
    # the data slots: the positions of the axes the batch dim splits over
    # (a sequence split is a layout only: whole sequences are computed).
    # A routed block ranks every token of its call against a capacity
    # set by their number, so a MoE arch computes the batch whole.
    batch_entry = None if cfg.family == "moe" \
        else batch_sh["tokens"].spec[0]
    data_slots = [mesh.device_at(**pos)
                  for pos in shd.slots((batch_entry,), mesh)]
    accum = GradAccumulator(n_micro)

    def loss_fn(pieces, batch):
        n_valid = torch.clamp(
            (batch["labels"] >= 0).sum().to(F32), min=1.0).to(dev0)
        rows = batch["tokens"].shape[0]
        if rows % len(data_slots):
            raise ValueError(f"a (micro)batch of {rows} rows does not split "
                             f"over {len(data_slots)} data slots")
        share = rows // len(data_slots)
        total = None
        for i, dev in enumerate(data_slots):
            p = shd.gather_tree(pieces, param_sh, dev)
            b = {k: v[i * share:(i + 1) * share].to(dev)
                 for k, v in batch.items()}
            logits = model.forward(p, b["tokens"],
                                   prefix_embed=b.get("prefix_embed"),
                                   mode="train", ctx_extra=ctx_extra)
            nll = token_nll(logits, b["labels"])[0].to(dev0)
            total = nll if total is None else total + nll
        return total / n_valid

    def value_and_grad(params, batch):
        pieces = shd.place_tree(params, param_sh)
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        return accum(loss_fn, pieces, batch)

    def train_step(params, opt_state, batch):
        pieces = shd.place_tree(params, param_sh)
        opt = _place_opt(opt_state, opt_sh, dev0)
        loss, grads = value_and_grad(pieces, batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = opt_update(grads, opt, pieces)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return BuiltStep(
        fn=train_step,
        abstract_args=(abstract_params, abstract_opt, in_specs),
        arg_shardings=(param_sh, opt_sh, batch_sh),
        model=model,
        meta={"moment_dtype": md, "kind": "train",
              "value_and_grad": value_and_grad,
              "data_slots": len(data_slots)},
    )


def _serving_params(cfg: ArchConfig, mesh, bfp_weights: bool):
    model = LMModel(cfg, _first_device(mesh))
    metas = model.param_meta()
    if bfp_weights:
        return (model, params_lib.bfp_abstract(metas),
                params_lib.bfp_shardings(metas, mesh))
    return (model, params_lib.abstract(metas),
            params_lib.shardings(metas, mesh))


def build_prefill(cfg: ArchConfig, mesh, shape: ShapeConfig, *,
                  bfp_weights: bool = False) -> BuiltStep:
    """``fn(params, batch) -> (last-position logits (B, V), the cache
    filled for decode)``, on the mesh's first slot."""
    model, abstract_params, param_sh = _serving_params(cfg, mesh,
                                                       bfp_weights)
    dev0 = _first_device(mesh)
    in_specs = input_specs(cfg, shape)
    batch_sh = shd.input_shardings(mesh, in_specs)
    # a VLM's vision prefix takes cache slots too
    max_len = shape.seq_len + (cfg.frontend_len if cfg.family == "vlm"
                               else 0)
    cstr = shd.activation_constrainer(mesh, shape.global_batch)

    def prefill(params, batch):
        params = shd.gather_tree(params, param_sh, dev0)
        batch = {k: torch.as_tensor(v).to(dev0) for k, v in batch.items()}
        logits, cache = model.forward(
            params, batch["tokens"], prefix_embed=batch.get("prefix_embed"),
            mode="serve", cache_out=True, max_len=max_len,
            ctx_extra={"shard": cstr})
        return logits[:, -1, :], cache

    return BuiltStep(
        fn=prefill,
        abstract_args=(abstract_params, in_specs),
        arg_shardings=(param_sh, batch_sh),
        model=model,
        meta={"kind": "prefill"},
    )


def build_serve_step(cfg: ArchConfig, mesh, shape: ShapeConfig, *,
                     bfp_weights: bool = False) -> BuiltStep:
    """``fn(params, cache, tokens (B, 1), cache_len) -> (next greedy
    token (B,) int32, the cache updated in place)``: one decode step
    against a ``seq_len``-deep cache, on the mesh's first slot."""
    model, abstract_params, param_sh = _serving_params(cfg, mesh,
                                                       bfp_weights)
    dev0 = _first_device(mesh)
    b = shape.global_batch
    cache_metas = model.cache_meta(b, shape.seq_len)
    cache_sh = params_lib.shardings(cache_metas, mesh)
    in_specs = input_specs(cfg, shape)
    tok_sh = shd.input_shardings(mesh, in_specs)
    cstr = shd.activation_constrainer(mesh, b)

    def serve_step(params, cache, tokens, cache_len):
        params = shd.gather_tree(params, param_sh, dev0)
        logits, new_cache = model.decode_step(
            params, torch.as_tensor(tokens).to(dev0), cache, int(cache_len),
            ctx_extra={"shard": cstr})
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return BuiltStep(
        fn=serve_step,
        abstract_args=(abstract_params, params_lib.abstract(cache_metas),
                       in_specs["tokens"], in_specs["cache_len"]),
        arg_shardings=(param_sh, cache_sh, tok_sh["tokens"],
                       shd.replicated(mesh)),
        model=model,
        meta={"kind": "decode"},
    )


def build_step(cfg: ArchConfig, mesh, shape: ShapeConfig, **kw) -> BuiltStep:
    """The builder of ``shape.kind``, given only the options it takes."""
    if shape.kind == "train":
        kw.pop("bfp_weights", None)
        return build_train_step(cfg, mesh, shape, **kw)
    kw.pop("moment_dtype", None)
    kw.pop("n_micro", None)
    if shape.kind == "prefill":
        return build_prefill(cfg, mesh, shape, **kw)
    return build_serve_step(cfg, mesh, shape, **kw)
