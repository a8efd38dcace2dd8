"""The LM family: language models served through ``serve_lm``, whose
results are tokens.

The hooks (see ``families/fcn.py`` for the list):

* ``make_params``: the plain reference's weights (the module the
  configuration's ``reference`` names under ``plain/``), drawn from
  ``weight_seed`` in the stated type and handed to the program by binding
  name (:func:`nest`);
* ``pool``: the prompts, from the mix and ``--seed``: one batch of
  ``batch`` prompts at each length of ``lengths``, token ids uniform
  over the vocabulary, and the cycle's starting point;
* ``check``: for each request the driver kept (its prefill's cache, its
  first token's logits and the logits of the greedy tokens decoded from
  that cache after the window), the reference's full forward over the
  prompt and those tokens, compared at the same positions as
  ``logit_gap_max`` (the largest |difference| of a request's logits) and
  ``logit_gap_mean`` (their mean), over L = the reference's largest
  |logit| of that request, worst request first; besides,
  ``failed_requests`` and ``requests_compared`` (a floor);
* ``control``: the reference at ``bits`` mantissa bits in the program's
  place, by the same numbers.

:func:`arch_config` is the program's configuration of the file's
published keys.  What depends on the architecture comes from the
reference module: ``make_params``, ``forward``, ``program_fields`` (the
program's configuration) and ``dims`` (the widths, through the
configuration's ``layers``, that ``counts_lm.py`` counts from), so that
another LM configuration is new files: its reference under ``plain/``,
its configuration files and its cell.
"""
from __future__ import annotations

import importlib
from typing import Dict

import numpy as np
import torch

FLOORS = ("requests_compared",)


def _reference(name: str):
    return importlib.import_module(f"perfbench.plain.{name}")


def reference(ctx):
    return _reference(ctx.config["reference"])


def arch_config(cfg):
    """The program's ``ArchConfig`` of a configuration file: the keywords
    its reference's ``program_fields`` gives."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(**_reference(cfg["reference"]).program_fields(cfg))


def nest(flat: Dict[str, torch.Tensor]):
    """Binding names ``a/b/c`` -> the program's nested tree (the same
    tensors, no copies)."""
    tree: Dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def make_params(ctx, device):
    return reference(ctx).make_params(ctx.config, ctx.config["weight_seed"],
                                      device)


def pool(ctx) -> Dict[str, object]:
    """``prompts[j]``: (batch, lengths[j]) int64 token ids; ``start``: the
    cycle's first index."""
    mix = ctx.traffic
    rng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed), 29]))
    lengths = [int(n) for n in mix["lengths"]]
    vocab = int(ctx.config["vocab_size"])
    return {"start": int(rng.integers(0, len(lengths))),
            "lengths": lengths,
            "prompts": [rng.integers(0, vocab, (int(mix["batch"]), n))
                        for n in lengths]}


def notes(served) -> Dict[str, str]:
    got = [t for _, t in served if t is not None]
    return {"requests": f"{len(served)} served, {len(got)} with a token"}


def _rows(ctx, params, rec, bits=None) -> torch.Tensor:
    """The reference's logits at the compared positions of a kept
    request (``rec["tokens"]``: the first token and the decoded ones):
    its last prompt position and each decoded token's."""
    prompt = rec["prompt"]
    toks = np.concatenate([prompt, rec["tokens"][:-1]])
    n = len(prompt)
    pos = list(range(n - 1, n - 1 + len(rec["tokens"])))
    x = torch.from_numpy(toks.astype(np.int64))[None].to(ctx.device)
    return reference(ctx).forward(ctx.config, params, x, positions=pos,
                                  bits=bits)[0]


def _gaps(got: torch.Tensor, want: torch.Tensor):
    d = (got.to(torch.float32) - want).abs()
    scale = float(want.abs().max().clamp_min(1e-30))
    return float(d.max()) / scale, float(d.mean()) / scale


def check(ctx, params, records, pool, served, failed):
    gmax = gmean = 0.0
    for rec in records:
        want = _rows(ctx, params, rec)
        got = torch.from_numpy(rec["logits"]).to(want.device)
        a, b = _gaps(got, want)
        gmax, gmean = max(gmax, a), max(gmean, b)
    lim = ctx.cell["limits"]
    return {
        "logit_gap_max": {"value": gmax, "limit": lim["logit_gap_max"]},
        "logit_gap_mean": {"value": gmean, "limit": lim["logit_gap_mean"]},
        "failed_requests": {"value": failed, "limit": 0},
        "requests_compared": {"value": len(records),
                              "limit": int(ctx.cell["sample_calls"])},
    }


def passed(checks) -> bool:
    return all(v["value"] >= v["limit"] if k in FLOORS
               else v["value"] <= v["limit"] for k, v in checks.items())


def control(ctx, params, records, pool, bits: int) -> Dict[str, float]:
    gmax = gmean = 0.0
    for rec in records:
        a, b = _gaps(_rows(ctx, params, rec, bits), _rows(ctx, params, rec))
        gmax, gmean = max(gmax, a), max(gmean, b)
    return {"logit_gap_max": gmax, "logit_gap_mean": gmean}

