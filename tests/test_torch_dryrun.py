"""The port's dry run (``repro_torch.launch.dryrun``) and the repairs it
needs, against the JAX package on the CPU: ``count_params`` and
``param_bytes`` of every arch's full parameter and cache trees, every
smoke arch's cells at the four shapes (cut small) on 1x1 and 2x4 meta
meshes with the reference's skip reasons, argument bytes per slot
against the reference's per-device shard bytes from its specs, the
counted FLOPs of a dense prefill against the sum of its matmuls, the
record's keys, a full-config Kimi-K2 decode cell, and the repairs:
``moe._ranks_by_sort`` counting by scatter-add (bit-equal to the
reference's and runnable on meta), ``resolve_device("meta")`` and
``Prefetcher`` asking for the card by default.

Nothing here allocates a model: the dry run runs on the meta device,
and the counts read shapes.
"""
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.models.lm import LMModel as JLMModel
from repro.models.lm import moe as jmoe
from repro.models.lm import params as jparams
from repro.runtime import sharding as jsharding
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.core import resolve_device
from repro_torch.data import Prefetcher, TokenDataset
from repro_torch.launch import dryrun
from repro_torch.models.lm import LMModel, moe
from repro_torch.models.lm import params as params_lib

from _archs import PORT_ONLY

torch.set_num_threads(2)

# the four shapes at their names (the skip rule reads the name), cut small
SMALL_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}
CACHE_SHAPES = ((32, 32768), (128, 32768), (1, 4096))


def _ref_mesh(shape):
    """What the reference's spec functions read of a mesh: axis names and
    the devices' shape (no device is needed)."""
    return types.SimpleNamespace(axis_names=dryrun.MESH_AXES,
                                 devices=np.empty(shape, dtype=object))


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_counts_equal_reference(arch):
    """count_params and param_bytes of the full config's parameters and
    caches, over ParamMeta trees and over meta-tensor trees (abstract,
    and bfp_abstract against the reference's bfp_abstract)."""
    model = LMModel(configs.get_config(arch), "meta")
    jm = JLMModel(jconfigs.get_config(arch))
    trees = [(model.param_meta(), jm.param_meta())]
    trees += [(model.cache_meta(b, s), jm.cache_meta(b, s))
              for b, s in CACHE_SHAPES]
    for mine, ref in trees:
        n, nb = jparams.count_params(ref), jparams.param_bytes(ref)
        assert params_lib.count_params(mine) == n
        assert params_lib.param_bytes(mine) == nb
        assert params_lib.count_params(params_lib.abstract(mine)) == n
        assert params_lib.param_bytes(params_lib.abstract(mine)) == nb
    mine, ref = trees[0]
    bfp_ref = jparams.bfp_abstract(ref)
    bfp_mine = params_lib.bfp_abstract(mine)
    assert params_lib.count_params(bfp_mine) == jparams.count_params(bfp_ref)
    assert params_lib.param_bytes(bfp_mine) == jparams.param_bytes(bfp_ref)


# ---------------------------------------------------------------------------
# run_cell over every smoke arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_smoke_cells_ok_or_reference_skip(arch, mesh, tmp_path):
    """Every smoke arch at the four shapes: ``ok`` on the meta device
    with nothing allocated elsewhere, or ``skipped`` for the reference's
    reason (the moe archs run: the routing counts by scatter-add); an
    arch the reference lacks (``PORT_ONLY``) skips for the port's own
    reason."""
    cf = configs if arch in PORT_ONLY else jconfigs
    jcfg = cf.get_smoke_config(arch)
    for name, shape in SMALL_SHAPES.items():
        rec = dryrun.run_cell(arch, shape, mesh=mesh, smoke=True,
                              report_dir=str(tmp_path), verbose=False)
        jshape = cf.base.ShapeConfig(name, shape.seq_len,
                                     shape.global_batch, shape.kind)
        ok, reason = cf.shape_applicable(jcfg, jshape)
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == reason
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["tensors_off_meta"] == 0
        assert rec["step_kind"] == shape.kind
        assert rec["flops"] > 0 and rec["aten_ops"] > 0
        assert (rec["memory"]["temp_size_bytes"] > 0) == (shape.kind
                                                           == "train")
        assert rec["n_devices"] == math.prod(MESHES[mesh])


def _leaf_bytes(shape, dtype, spec, sizes) -> int:
    n = math.prod(sizes[a] for entry in spec if entry is not None
                  for a in (entry if isinstance(entry, tuple) else (entry,)))
    b = math.prod(shape) * jnp.dtype(dtype).itemsize
    assert b % n == 0
    return b // n


def _ref_tree_bytes(meta_tree, mesh, sizes, dtype=None) -> int:
    specs = jparams.specs(meta_tree, mesh)
    metas = jax.tree_util.tree_leaves(meta_tree, is_leaf=jparams.is_meta)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sum(_leaf_bytes(m.shape, dtype or m.dtype, tuple(s), sizes)
               for m, s in zip(metas, spec_leaves, strict=True))


def _ref_arg_bytes(arch, shape, mesh_shape) -> int:
    """The reference's per-device shard bytes of a cell's arguments, from
    its specs: params, f32 AdamW moments and the step counter (train),
    the inputs per ``batch_seq_spec``, the cache (decode)."""
    jcfg = jconfigs.get_smoke_config(arch)
    jm = JLMModel(jcfg)
    mesh = _ref_mesh(mesh_shape)
    sizes = dict(zip(dryrun.MESH_AXES, mesh_shape))
    jshape = jconfigs.base.ShapeConfig(shape.name, shape.seq_len,
                                       shape.global_batch, shape.kind)
    total = _ref_tree_bytes(jm.param_meta(), mesh, sizes)
    if shape.kind == "train":
        total += 2 * _ref_tree_bytes(jm.param_meta(), mesh, sizes,
                                     jnp.float32) + 4
    if shape.kind == "decode":
        total += _ref_tree_bytes(
            jm.cache_meta(shape.global_batch, shape.seq_len), mesh, sizes)
    for sds in jconfigs.input_specs(jcfg, jshape).values():
        if sds.ndim == 0:
            spec = ()
        elif sds.ndim == 1:
            spec = tuple(jsharding.batch_seq_spec(mesh, sds.shape[0]))
        else:
            spec = tuple(jsharding.batch_seq_spec(mesh, sds.shape[0],
                                                  sds.shape[1]))
        total += _leaf_bytes(sds.shape, sds.dtype, spec, sizes)
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "grok-1-314b",
                                  "zamba2-2.7b", "internvl2-76b"])
def test_argument_bytes_equal_reference_shards(arch, mesh, tmp_path):
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SMALL_SHAPES[name]
        rec = dryrun.run_cell(arch, shape, mesh=mesh, smoke=True,
                              report_dir=str(tmp_path), verbose=False)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["memory"]["argument_size_bytes"] == _ref_arg_bytes(
            arch, shape, MESHES[mesh])
        assert rec["memory"]["output_size_bytes"] == _output_bytes(
            arch, shape, MESHES[mesh])


def _output_bytes(arch, shape, mesh_shape) -> int:
    """What a step returns beside its arguments: a train step's new
    params and f32 moments (and step counter) in their shards, a
    prefill's filled cache and its last-position logits, a view that
    keeps the whole (B, L, V) f32 logits (the head runs over every
    position, as in the reference), a decode step's int32 tokens (its
    cache is written in place)."""
    jcfg = jconfigs.get_smoke_config(arch)
    jm = JLMModel(jcfg)
    B = shape.global_batch
    if shape.kind == "train":
        mesh, sizes = _ref_mesh(mesh_shape), dict(zip(dryrun.MESH_AXES,
                                                      mesh_shape))
        return (_ref_tree_bytes(jm.param_meta(), mesh, sizes)
                + 2 * _ref_tree_bytes(jm.param_meta(), mesh, sizes,
                                      jnp.float32) + 4)
    if shape.kind == "decode":
        return B * 4
    max_len = shape.seq_len + (jcfg.frontend_len if jcfg.family == "vlm"
                               else 0)
    return (B * max_len * jcfg.vocab * 4
            + jparams.param_bytes(jm.cache_meta(B, max_len)))


def test_dense_prefill_flops_are_the_sum_of_its_matmuls(tmp_path):
    """A dense smoke prefill: 2·m·n·k summed over the q, k, v, o
    projections, both attention products (every query against every key:
    the plain route masks after the product), the SwiGLU's three matmuls
    and the head over every position."""
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    shape = ShapeConfig("prefill", 48, 4, "prefill")
    rec = dryrun.run_cell("tinyllama-1.1b", shape, smoke=True,
                          report_dir=str(tmp_path), verbose=False)
    B, S = shape.global_batch, shape.seq_len
    T, d, H, K, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    per_layer = (2 * T * d * (H + 2 * K) * hd       # q, k, v
                 + 2 * T * H * hd * d                # o
                 + 2 * 2 * B * H * S * S * hd        # scores and P.V
                 + 3 * 2 * T * d * cfg.d_ff)         # gate, up, down
    want = cfg.n_layers * per_layer + 2 * T * d * cfg.vocab
    assert rec["flops"] == want
    assert rec["flops_per_device"] == want


def test_record_keys_and_main(tmp_path, monkeypatch):
    """The JSON written carries the reference's keys where they carry
    over; ``main`` exits 0 on a clean sweep, reads ``--skip-existing``,
    and exits 1 when a cell fails."""
    carried = {"arch", "shape", "mesh", "n_devices", "status", "step_kind",
               "flops_per_device", "memory"}
    d = str(tmp_path)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                     "--smoke", "--mesh", "1x1", "2x4", "--report-dir", d])
    assert e.value.code == 0
    for mesh in ("1x1", "2x4"):
        with open(tmp_path /
                  f"tinyllama-1.1b__decode_32k__{mesh}__smoke.json") as f:
            rec = json.load(f)
        assert carried <= set(rec) and rec["smoke"] is True
        assert {"argument_size_bytes", "temp_size_bytes"} <= set(
            rec["memory"])
        assert rec["mesh"] == mesh and rec["status"] == "ok"
    rec = dryrun.run_cell("tinyllama-1.1b", "long_500k", smoke=True,
                          report_dir=d, verbose=False)
    with open(tmp_path / "tinyllama-1.1b__long_500k__1x1__smoke.json") as f:
        assert json.load(f) == rec
    assert {"status", "reason"} <= set(rec) and rec["status"] == "skipped"
    bad = dryrun.run_cell("tinyllama-1.1b", SMALL_SHAPES["train_4k"],
                          smoke=True, report_dir=d, verbose=False,
                          moment_dtype="float64")
    assert bad["status"] == "error" and "moment_dtype" in bad["error"]
    assert "Traceback" in bad["traceback"]
    calls = []
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: calls.append(a) or {"status": "error"})
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                     "--mesh", "1x1", "2x4", "3x1", "--skip-existing",
                     "--report-dir", d])
    assert e.value.code == 1
    # the smoke records are not the full cells': every mesh runs
    assert calls == [("tinyllama-1.1b", "decode_32k")] * 3
    calls.clear()
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                     "--smoke", "--mesh", "1x1", "2x4", "3x1",
                     "--skip-existing", "--report-dir", d])
    assert e.value.code == 1
    assert calls == [("tinyllama-1.1b", "decode_32k")]   # 3x1 only
    with pytest.raises(ValueError, match="DATAxMODEL"):
        dryrun.parse_mesh("2x2x2")


def test_full_kimi_decode_cell_runs_on_meta(tmp_path):
    """Kimi-K2 as published (1.03 T parameters, 384 routed experts) at
    decode_32k: the cache and the weights on meta, nothing allocated."""
    rec = dryrun.run_cell("kimi-k2-1t-a32b", "decode_32k",
                          report_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["tensors_off_meta"] == 0
    assert rec["n_params"] == configs.get_config(
        "kimi-k2-1t-a32b").param_count()
    assert rec["memory"]["argument_size_bytes"] > rec["param_bytes"]


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

def _routings():
    rng = np.random.default_rng(0)
    yield "uniform", rng.integers(0, 16, size=512), 16
    yield "skewed", np.minimum(rng.geometric(0.3, size=512) - 1, 15), 16
    yield "one expert", np.full(64, 5), 8
    yield "unused experts", rng.integers(0, 3, size=200), 64


@pytest.mark.parametrize("case", list(range(4)))
def test_ranks_by_sort_bit_equal_reference(case):
    name, ids, n_experts = list(_routings())[case]
    got = moe._ranks_by_sort(torch.tensor(ids, dtype=torch.int64),
                             n_experts)
    want = np.asarray(jmoe._ranks_by_sort(jnp.asarray(ids, jnp.int32),
                                          n_experts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    meta = moe._ranks_by_sort(torch.tensor(ids, device="meta"), n_experts)
    assert meta.shape == got.shape and meta.dtype == torch.int32


def test_resolve_device_meta_and_refusals():
    assert resolve_device("meta") == torch.device("meta")
    assert LMModel(configs.get_smoke_config("mamba2-370m"),
                   "meta").device.type == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def test_prefetcher_asks_for_the_card(monkeypatch):
    """Prefetcher() puts batches on the card by default: without one it
    raises resolve_device's error; on the CPU it gives the reference's
    Prefetcher's values in its types."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Prefetcher(iter([]))
    ds = TokenDataset(50, 8, 2, seed=0)
    assert ds.batch(0)["tokens"].dtype == np.int64     # the repeat stream
    got = next(Prefetcher(iter([ds.batch(0)]), device="cpu"))
    want = next(JPrefetcher(iter([ds.batch(0)])))
    for k in ("tokens", "labels"):
        # 64-bit arrays arrive in 32 bits, as jnp.asarray gives them
        assert got[k].device.type == "cpu"
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
