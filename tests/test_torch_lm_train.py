"""LM training in repro_torch against the JAX reference on the CPU: the
K4/K5 refusal of autograd, the item-5b counters, the token stream and
its prefetcher, the sharding specs of every full config, one train step
of each smoke arch against ``jax.value_and_grad`` and the reference's
``build_train_step``, the hybrid's shared-block gradient, recomputation
(remat) against none, the step split over a (2, 4) host mesh against the
single-device step, and ``launch.train`` against the reference's loop,
resume included.

Weights are the reference's ``init_params(PRNGKey(0))`` carried across
leaf for leaf; inputs come from numpy.  Tolerances: losses within 1e-4
(the bound of ``tests/test_distributed.py::TestShardedTraining``);
gradients within 1e-4 of each leaf's largest |g| (the rule of
``tests/test_torch_train.py``); the AdamW update (the parameters after
the step less before) within 2·lr of the other side's, since the first
step moves a parameter by about lr·sign(g) and a near-zero gradient
whose sign differs moves it by up to 2·lr, and within lr/2 of it on
99.9% of the entries the other side moved by over 3/4·lr (at least half
of them), so a step that leaves the parameters unchanged fails.

Every arch's attention projections are rescaled to their true fan-in
before either package sees them (``params.scale_attention_to_fan_in``,
which the port's ``init_params`` applies to its own draws).  The
reference's init takes the head count as the fan-in, so its softmaxes
come out near one-hot and a rounding in one f32 run moves a gradient
many-fold: on the weights as drawn Whisper's gradients end 4.1e-4 of a
leaf's largest |g| from the reference's, and with three masked labels
TinyLlama's and InternLM2's embedding gradients 1.2e-4 and 1.35e-4.
"""
import dataclasses
import os
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import bfp as jbfp
from repro.core import fuse as jfuse
from repro.core import winograd as jwinograd
from repro.data import Prefetcher as JPrefetcher
from repro.data import TokenDataset as JTokenDataset
from repro.launch import step_fns as jstep_fns
from repro.launch import train as jtrain
from repro.models.lm import LMModel as JLMModel
from repro.models.lm import cross_entropy as jcross_entropy
from repro.models.lm import params as jparams
from repro.runtime import fault_tolerance as jfault
from repro.runtime import sharding as jsharding
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import bfp, fuse, winograd
from repro_torch.core import tree as tree_lib
from repro_torch.data import Prefetcher, TokenDataset
from repro_torch.kernels.flash_attention import flash_attention_padded
from repro_torch.kernels.ssd_scan import ssd_chunk
from repro_torch.launch import step_fns, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LMModel, cross_entropy
from repro_torch.models.lm import params as params_lib
from repro_torch.optim import (adamw, clip_by_global_norm,
                               cosine_with_warmup, value_and_grad)
from repro_torch.runtime import sharding

torch.set_num_threads(2)

KERNEL_CTX = {"use_flash": True, "use_kernel": True}
MESHES = {"data2_model4": ((2, 4), ("data", "model")),
          "data1_model8": ((1, 8), ("data", "model")),
          "pod2_data4_model4": ((2, 4, 4), ("pod", "data", "model"))}


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32) * scale)


def _scaled_tree(jtree):
    """A reference parameter tree (f32) with its attention projections at
    their true fan-in, by the port's ``scale_attention_to_fan_in``."""
    port = params_lib.scale_attention_to_fan_in(
        params_lib.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            jtree)))
    return jax.tree_util.tree_map(
        jnp.asarray, tree_lib.tree_map(lambda t: t.numpy(), port))


def _models(arch):
    """(reference model, its PRNGKey(0) params fan-in scaled, the port's
    model, the same params carried across)."""
    jm = JLMModel(jconfigs.get_smoke_config(arch))
    ref = _scaled_tree(jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    return (jm, ref, LMModel(configs.get_smoke_config(arch), "cpu"),
            params_lib.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, ref)))


def _prefix(cfg, batch, seed=9):
    if cfg.frontend == "none":
        return {}, {}
    pf = np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.1
    return {"prefix_embed": jnp.asarray(pf)}, \
        {"prefix_embed": torch.from_numpy(pf)}


def _assert_grads_close(got, want, tol=1e-4):
    """Every leaf within ``tol`` of the reference leaf's largest |g|."""
    got_leaves = tree_lib.flatten_with_paths(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for (path, g), w in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (path, err, scale)


def _assert_update_close(before, after, want_before, want_after, lr):
    """The update ``after - before`` against ``want_after - want_before``:
    every entry within 2·lr, and 99.9% of the entries the other side
    moved by over 3/4·lr (at least half of all) within lr/2."""
    n_moved = n_close = n = 0
    for b, a, wb, wa in zip(before, after, want_before, want_after,
                            strict=True):
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        w = np.asarray(wa, np.float64) - np.asarray(wb, np.float64)
        err = np.abs(d - w)
        assert float(err.max()) <= 2 * lr, float(err.max())
        moved = np.abs(w) > 0.75 * lr
        n += w.size
        n_moved += int(moved.sum())
        n_close += int((err[moved] <= 0.5 * lr).sum())
    assert n_moved >= 0.5 * n, (n_moved, n)
    assert n_close >= 0.999 * n_moved, (n_close, n_moved)


def _numpy_leaves(tree):
    return [t.detach().float().numpy() for t in tree_lib.leaves(tree)]


# ---------------------------------------------------------------------------
# K4 and K5 refuse autograd
# ---------------------------------------------------------------------------

def _k4_k5_calls(requires_grad: bool):
    q, k, v = (_normal(i, (1, 2, 8, 16)).requires_grad_(requires_grad)
               for i in range(3))
    c, b = (_normal(i, (2, 1, 8, 4)).requires_grad_(requires_grad)
            for i in (3, 4))
    xdt = _normal(5, (2, 1, 2, 8, 4)).requires_grad_(requires_grad)
    scum = -torch.cumsum(_normal(6, (2, 1, 2, 8, 1)).abs(), dim=3)
    return [lambda: flash_attention_padded(q, k, v, sm_scale=0.25,
                                           causal=True, kv_len=8),
            lambda: ssd_chunk(c, b, xdt, scum)]


def test_k4_k5_wrappers_refuse_autograd():
    """Operands that require grad: both wrappers raise "no backward" on
    the CPU, as on the card; under no_grad, or with no operand requiring
    grad, they run their plain versions."""
    for call in _k4_k5_calls(True):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    for call in _k4_k5_calls(False):
        call()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m"])
def test_lm_forward_through_kernels_refuses_autograd(arch):
    """A train-mode forward with the kernels' routes on parameters that
    require grad raises (the reference's Pallas kernels have no VJP
    either); under no_grad it runs, and without the routes it trains."""
    model = LMModel(configs.get_smoke_config(arch), "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    live = tree_lib.tree_map(lambda p: p.requires_grad_(True), params)
    toks = torch.randint(0, model.cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="no backward"):
        model.forward(live, toks, ctx_extra=KERNEL_CTX)
    with torch.no_grad():
        assert model.forward(live, toks, ctx_extra=KERNEL_CTX).grad_fn is None
    assert model.forward(live, toks).grad_fn is not None


# ---------------------------------------------------------------------------
# item 5b: the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,cin,cout", [
    (1, 1, 1, 1), (4, 4, 3, 64), (7, 13, 5, 9), (64, 64, 64, 64),
    (128, 96, 128, 256), (33, 17, 512, 3)])
def test_counters_equal_reference(h, w, cin, cout):
    assert winograd.multiply_count(h, w, cin, cout) == \
        jwinograd.multiply_count(h, w, cin, cout)
    assert fuse.upsample_mac_counts(h, w, cin, cout) == \
        jfuse.upsample_mac_counts(h, w, cin, cout)


def test_wide_mantissa_equals_reference():
    assert bfp.WIDE_MANTISSA == jbfp.WIDE_MANTISSA == 15


# ---------------------------------------------------------------------------
# the token stream (tests/test_substrate.py::TestData, mirrored)
# ---------------------------------------------------------------------------

class TestData:
    def test_deterministic_per_step(self):
        ds = TokenDataset(100, 32, 8, seed=3)
        a, b = ds.batch(17), ds.batch(17)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert not np.array_equal(a["tokens"], ds.batch(18)["tokens"])

    def test_host_sharding_disjoint(self):
        d0 = TokenDataset(100, 16, 8, seed=1, n_hosts=2, host_id=0)
        d1 = TokenDataset(100, 16, 8, seed=1, n_hosts=2, host_id=1)
        assert d0.local_batch == 4
        assert not np.array_equal(d0.batch(0)["tokens"],
                                  d1.batch(0)["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = TokenDataset(100, 16, 4, seed=0).batch(0)
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        assert (b["labels"][:, -1] == -1).all()

    def test_prefetcher_yields_all(self):
        ds = TokenDataset(50, 8, 2, seed=0)
        got = list(Prefetcher((ds.batch(i) for i in range(5)), device="cpu"))
        assert len(got) == 5
        np.testing.assert_array_equal(np.asarray(got[3]["tokens"]),
                                      ds.batch(3)["tokens"])
        ref = list(JPrefetcher(ds.batch(i) for i in range(5)))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a["labels"].numpy(),
                                          np.asarray(b["labels"]))


@pytest.mark.parametrize("structure", ["repeat", "uniform"])
@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (3, 2), (11, 4)])
def test_token_batches_bit_equal_reference(structure, seed, n_hosts):
    for host in range(n_hosts):
        kw = dict(seed=seed, n_hosts=n_hosts, host_id=host,
                  structure=structure)
        mine = TokenDataset(1000, 24, 8, **kw)
        ref = JTokenDataset(1000, 24, 8, **kw)
        for step in (0, 1, 17, 12345):
            a, b = mine.batch(step), ref.batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def _ref_mesh(shape, axes):
    """What the reference's spec functions read of a mesh: axis names and
    the devices' shape (no device is needed)."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _port_specs(meta, mesh):
    return dict(params_lib.leaves_with_path(params_lib.specs(meta, mesh)))


def _ref_specs(meta, mesh):
    leaves = jax.tree_util.tree_leaves_with_path(
        jparams.specs(meta, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(k.key for k in path): tuple(spec) for path, spec in leaves}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_reference(arch, mesh_name):
    """Every leaf of the full config's parameters and caches (prefill and
    decode shapes) resolves to the reference's spec, and the BFP weight
    storage's mantissa and exponent specs too.  Metadata only: nothing is
    allocated."""
    shape, axes = MESHES[mesh_name]
    mesh = make_host_mesh(shape, axes, device="cpu")
    jmesh = _ref_mesh(shape, axes)
    model = LMModel(configs.get_config(arch), "cpu")
    jm = JLMModel(jconfigs.get_config(arch))
    trees = [(model.param_meta(), jm.param_meta())]
    for b, s in ((32, 32768), (128, 32768), (1, 4096)):
        trees.append((model.cache_meta(b, s), jm.cache_meta(b, s)))
    for mine, ref in trees:
        assert _port_specs(mine, mesh) == _ref_specs(ref, jmesh)
    got = {path: (sh.mantissa.spec, sh.exponent.spec)
           if isinstance(sh, bfp.BFPTensor) else sh.spec
           for path, sh in params_lib.leaves_with_path(
               params_lib.bfp_shardings(trees[0][0], mesh))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jparams, "NamedSharding", lambda m, spec: tuple(spec))
        ref = jparams.bfp_shardings(trees[0][1], jmesh)
    want = {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(
                ref, is_leaf=lambda x: isinstance(x, (tuple, jbfp.BFPTensor)))}
    want = {k: (v.mantissa, v.exponent) if isinstance(v, jbfp.BFPTensor)
            else v for k, v in want.items()}
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_input_and_activation_specs_equal_reference(mesh_name, monkeypatch):
    """batch_seq_spec, input_shardings, logits_spec and the activation
    constrainer's specs, over batches that do and do not divide the
    batch axes (the sequence then takes them)."""
    shape, axes = MESHES[mesh_name]
    mesh = make_host_mesh(shape, axes, device="cpu")
    jmesh = _ref_mesh(shape, axes)
    monkeypatch.setattr(jsharding, "NamedSharding",
                        lambda m, spec: tuple(spec))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    for batch in (1, 2, 4, 6, 8, 16, 256):
        for seq in (None, 1, 16, 4096):
            assert sharding.batch_seq_spec(mesh, batch, seq) == \
                tuple(jsharding.batch_seq_spec(jmesh, batch, seq))
        assert sharding.logits_spec(mesh, batch, 4096) == \
            tuple(jsharding.logits_spec(jmesh, batch, 4096))
        for seq_shard in (False, True):
            mine = sharding.activation_constrainer(mesh, batch, seq_shard)
            ref = jsharding.activation_constrainer(jmesh, batch, seq_shard)
            for kind, dims in (("bld", (batch, 64, 32)),
                               ("boundary", (batch, 64, 32)),
                               ("boundary", (batch, 6, 32)),
                               ("blhd", (batch, 64, 8, 16)),
                               ("blhd", (batch, 64, 6, 16)),
                               ("ecd", (16, 5, 32)), ("ecd", (6, 5, 32))):
                assert mine.spec(dims, kind) == \
                    ref(jax.ShapeDtypeStruct(dims, jnp.float32), kind)
    for arch in ("tinyllama-1.1b", "whisper-tiny"):
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
            got = sharding.input_shardings(
                mesh, configs.input_specs(cfg, configs.SHAPES[name]))
            want = jsharding.input_shardings(
                jmesh, jconfigs.input_specs(jcfg, jconfigs.SHAPES[name]))
            assert {k: v.spec for k, v in got.items()} == want
    assert sharding.replicated(mesh).spec == ()


def test_constrainer_checks_and_returns_the_input():
    """The constrainer changes no value: it hands back its input, a data
    slot's share of the global batch included; a split that does not
    divide raises."""
    mesh = make_host_mesh((2, 4), ("data", "model"), device="cpu")
    shard = sharding.activation_constrainer(mesh, 4, seq_shard=True)
    for kind, x in (("bld", torch.zeros(2, 8, 6)),
                    ("boundary", torch.zeros(2, 8, 6)),
                    ("blhd", torch.zeros(2, 8, 4, 3)),
                    ("ecd", torch.zeros(8, 3, 6))):
        assert shard(x, kind) is x
    with pytest.raises(ValueError, match="does not split"):
        sharding.split(torch.zeros(3, 2), ("data",), mesh)


def test_split_and_gather_roundtrip_and_gradient():
    """Pieces over every named axis, in the reference's axis order; the
    gather puts them back and its gradient comes back split alike."""
    mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"),
                          device="cpu")
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for spec in ((("pod", "data"), "model"), (None, "model", "data"),
                 ("data",), ()):
        pieces = sharding.split(x, spec, mesh)
        assert len(pieces) == 2 ** len(sharding.named_axes(spec))
        live = [p.requires_grad_(True) for p in pieces]
        whole = sharding.gather(live, spec, mesh, "cpu")
        assert torch.equal(whole, x)
        grads = torch.autograd.grad((whole * x).sum(), live)
        for g, p in zip(grads, sharding.split(x, spec, mesh)):
            assert torch.equal(g, p)
    assert torch.equal(sharding.split(x, ("pod",), mesh)[1], x[4:])


# ---------------------------------------------------------------------------
# one train step per arch
# ---------------------------------------------------------------------------

def _ref_train_step(jm, ref, batch, jkw):
    """The reference's build_train_step on a 1x1 mesh of its one CPU
    device: (loss, grad_norm, new params, new opt state)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    cfg = jm.cfg
    shape = JShapeConfig("t", batch["tokens"].shape[1],
                         batch["tokens"].shape[0], "train")
    built = jstep_fns.build_train_step(cfg, mesh, shape,
                                       moment_dtype="float32")
    opt_init = jstep_fns.adamw(jstep_fns.cosine_with_warmup(3e-4, 2000,
                                                            100_000))[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch.update(jkw)
    with mesh:
        p2, o2, m = built.fn(ref, opt_init(ref), jbatch)
    return m, p2, o2


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_matches_reference(arch):
    """Loss and gradients against jax.value_and_grad, then one AdamW step
    through build_train_step on a one-slot mesh against the reference's
    (loss, grad norm, both moments, parameters)."""
    jm, ref, model, p = _models(arch)
    cfg = model.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = toks.copy()
    labels[0, -3:] = -1
    jkw, kw = _prefix(cfg, 2)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: jcross_entropy(jm.forward(q, jnp.asarray(toks), **jkw),
                                 jnp.asarray(labels))))(ref)
    l, g = value_and_grad(
        lambda q: cross_entropy(model.forward(q, torch.from_numpy(toks),
                                              **kw),
                                torch.from_numpy(labels)), p)
    assert abs(float(l) - float(jl)) <= 1e-4
    _assert_grads_close(g, jg)

    batch = {"tokens": toks, "labels": labels}
    jm_, jp2, jo2 = _ref_train_step(jm, ref, batch, jkw)
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cpu")
    built = step_fns.build_train_step(cfg, mesh, ShapeConfig("t", 16, 2,
                                                             "train"),
                                      moment_dtype="float32")
    opt_init = adamw(cosine_with_warmup(3e-4, 2000, 100_000))[0]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch.update(kw)
    p2, o2, m = built.fn(p, opt_init(p), tbatch)
    assert abs(float(m["loss"]) - float(jm_["loss"])) <= 1e-4
    assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]),
                                                  rel=1e-4)
    param_sh, opt_sh, _ = built.arg_shardings
    for got, want in ((sharding.gather_tree(o2.mu, opt_sh.mu, "cpu"),
                       jo2.mu),
                      (sharding.gather_tree(o2.nu, opt_sh.nu, "cpu"),
                       jo2.nu)):
        _assert_grads_close(got, want)
    # p holds the reference's starting values (its own were donated)
    _assert_update_close(
        _numpy_leaves(p), _numpy_leaves(sharding.gather_tree(p2, param_sh,
                                                             "cpu")),
        _numpy_leaves(p), jax.tree_util.tree_leaves(jp2), 3e-4 / 2000)
    assert int(o2.step) == 1


def test_grad_flows_to_shared_block():
    """Zamba2: both call sites of the one shared attention block
    contribute a gradient, equal to jax.grad's."""
    jm, ref, model, p = _models("zamba2-2.7b")
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab, (1, 8)) \
        .astype(np.int32)
    jg = jax.jit(jax.grad(lambda q: jcross_entropy(
        jm.forward(q, jnp.asarray(toks)), jnp.asarray(toks))))(ref)
    _, g = value_and_grad(lambda q: cross_entropy(
        model.forward(q, torch.from_numpy(toks)), torch.from_numpy(toks)), p)
    got = g["shared_attn"]["shared_attn"]["wq"]
    assert float(torch.linalg.norm(got)) > 0
    _assert_grads_close(g["shared_attn"], jg["shared_attn"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b",
                                  "whisper-tiny", "grok-1-314b"])
def test_remat_is_bit_equal(arch):
    """Recomputing each layer in the backward gives the very loss and
    gradients of keeping its activations (CPU)."""
    cfg = configs.get_smoke_config(arch)
    params = LMModel(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    _, kw = _prefix(cfg, 2)
    out = []
    for remat in (False, True):
        model = LMModel(dataclasses.replace(cfg, remat=remat), "cpu")
        out.append(value_and_grad(lambda q: cross_entropy(
            model.forward(q, toks, **kw), toks), params))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_lib.leaves(g0), tree_lib.leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the step on a (2, 4) host mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_micro,moments,mesh_shape", [
    ("tinyllama-1.1b", 1, "float32", (2, 4)),
    ("tinyllama-1.1b", 1, "bfp8", (2, 1)),
    ("grok-1-314b", 1, "float32", (2, 4)),
    ("zamba2-2.7b", 2, "float32", (2, 4))])
def test_sharded_step_matches_single_device(arch, n_micro, moments,
                                            mesh_shape):
    """Every leaf split over "data" and "model" as its spec says, the batch
    over 2 data slots whose shares hold different numbers of -1 labels:
    loss within 1e-4 of the single-device step's, gradients within 1e-4
    of each leaf's largest |g|, and the updates of two steps, the second
    from the pieces the first returned, held to the single-device steps'
    (bfp8 moments quantized piece by piece, in whole blocks)."""
    _, _, model, p = _models(arch)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    labels[0, :11] = -1                # slot 0 holds 11 of them, slot 1 one
    labels[3, -1] = -1
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    mesh = make_host_mesh(mesh_shape, ("data", "model"), device="cpu")
    built = step_fns.build_train_step(cfg, mesh,
                                      ShapeConfig("t", 16, 4, "train"),
                                      moment_dtype=moments,
                                      n_micro=n_micro)
    param_sh = built.arg_shardings[0]
    pieces = sharding.place_tree(p, param_sh)
    assert max(len(v) for _, v in params_lib.leaves_with_path(pieces)) == \
        mesh_shape[0] * mesh_shape[1]
    opt_init, opt_update = adamw(cosine_with_warmup(3e-4, 2000, 100_000),
                                 moment_dtype=moments)

    def single(q, b):
        return cross_entropy(model.forward(q, b["tokens"]), b["labels"])

    from repro_torch.optim.grad_utils import GradAccumulator
    l, g = GradAccumulator(n_micro)(single, p, batch)
    sl, sg = built.meta["value_and_grad"](pieces, batch)
    assert abs(float(sl) - float(l)) <= 1e-4
    got = sharding.gather_tree(sg, param_sh, "cpu")
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(g)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    p2, o2, m = built.fn(p, opt_init(p), batch)
    assert abs(float(m["loss"]) - float(l)) <= 1e-4
    want, want_opt = opt_update(clip_by_global_norm(g, 1.0)[0],
                                opt_init(p), p)
    got = sharding.gather_tree(p2, param_sh, "cpu")
    _assert_update_close(_numpy_leaves(p), _numpy_leaves(got),
                         _numpy_leaves(p), _numpy_leaves(want), 3e-4 / 2000)
    # a second step takes the pieces the first returned
    p3, o3, m3 = built.fn(p2, o2, batch)
    l2, g2 = GradAccumulator(n_micro)(single, want, batch)
    want2, _ = opt_update(clip_by_global_norm(g2, 1.0)[0], want_opt, want)
    assert int(o3.step) == 2
    assert abs(float(m3["loss"]) - float(l2)) <= 1e-4
    _assert_update_close(
        _numpy_leaves(got),
        _numpy_leaves(sharding.gather_tree(p3, param_sh, "cpu")),
        _numpy_leaves(want), _numpy_leaves(want2), 2 * 3e-4 / 2000)


def test_opt_state_crosses_leaf_for_leaf():
    """The reference's AdamW state (bfp8 moments, after one update) comes
    across by ``params_from_numpy`` leaf for leaf, bit-equal, and the
    port's next update of it matches the reference's."""
    from repro.optim import adamw as j_adamw
    from repro_torch.optim import OptState

    rng = np.random.default_rng(5)
    ref = {"w": jnp.asarray(rng.standard_normal((3, 64)), jnp.float32),
           "n": {"scale": jnp.asarray(rng.standard_normal(96),
                                      jnp.bfloat16)}}
    j_init, j_update = j_adamw(1e-2, moment_dtype="bfp8")
    grads = jax.tree_util.tree_map(lambda x: jnp.full(x.shape, 0.5), ref)
    jp, jst = j_update(grads, j_init(ref), ref)
    st = params_lib.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             jst))
    p = params_lib.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert isinstance(st, OptState) and int(st.step) == 1
    got, want = tree_lib.leaves(st), jax.tree_util.tree_leaves(jst)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.array(b)
        if b.dtype.name == "bfloat16":          # compare the bits
            a, b = a.view(torch.int16), b.view(np.int16)
        assert a.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    jp2, _ = j_update(grads, jst, jp)
    p2, _ = adamw(1e-2, moment_dtype="bfp8")[1](
        tree_lib.tree_map(lambda t: torch.full(t.shape, 0.5), p), st, p)
    for a, b in zip(tree_lib.leaves(p2), jax.tree_util.tree_leaves(jp2)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=1e-6)


def test_bfp8_moments_refuse_split_blocks():
    """A bfp8 moment is quantized piece by piece: a last dim split into
    pieces that are not whole 32-value blocks is refused (the smoke
    TinyLlama's d_ff of 96 over 4 "model" slots)."""
    mesh = make_host_mesh((2, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="whole 32-value blocks"):
        step_fns.build_train_step(
            configs.get_smoke_config("tinyllama-1.1b"), mesh,
            ShapeConfig("t", 16, 4, "train"), moment_dtype="bfp8")


def test_build_step_abstract_args_allocate_nothing():
    """The builders' stand-ins are meta tensors shaped like the reference's
    ShapeDtypeStructs, for the full TinyLlama config's train, prefill and
    decode cells."""
    cfg, jcfg = configs.get_config("tinyllama-1.1b"), \
        jconfigs.get_config("tinyllama-1.1b")
    mesh = make_host_mesh((2, 4), ("data", "model"), device="cpu")
    assert step_fns.default_moment_dtype(cfg) == \
        jstep_fns.default_moment_dtype(jcfg)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        built = step_fns.build_step(cfg, mesh, configs.SHAPES[name],
                                    moment_dtype="bfp8")
        leaves = tree_lib.leaves(built.abstract_args)
        assert leaves and all(t.device.type == "meta" for t in leaves)
    jmeta = jparams.abstract(JLMModel(jcfg).param_meta())
    got = tree_lib.leaves(built.abstract_args[0])
    want = jax.tree_util.tree_leaves(jmeta)
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_serving_builders_match_reference(arch):
    """build_prefill's last-position logits and build_serve_step's next
    token, from pieces placed on a (2, 4) host mesh, against the
    reference's builders on its one-device mesh (logits 1e-4)."""
    jm, ref, model, p = _models(arch)
    cfg = model.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)) \
        .astype(np.int32)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jpre = jstep_fns.build_prefill(jm.cfg, jmesh,
                                   JShapeConfig("p", 8, 2, "prefill"))
    jdec = jstep_fns.build_serve_step(jm.cfg, jmesh,
                                      JShapeConfig("d", 8, 2, "decode"))
    mesh = make_host_mesh((2, 4), ("data", "model"), device="cpu")
    pre = step_fns.build_prefill(cfg, mesh, ShapeConfig("p", 8, 2,
                                                        "prefill"))
    dec = step_fns.build_serve_step(cfg, mesh, ShapeConfig("d", 8, 2,
                                                           "decode"))
    pieces = sharding.place_tree(p, pre.arg_shardings[0])
    with jmesh:
        jlast, _ = jpre.fn(ref, {"tokens": jnp.asarray(toks)})
    last, cache = pre.fn(pieces, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=1e-4)
    # a decode step at position 7 against an 8-deep cache holding 7 tokens
    _, cache = pre.fn(p, {"tokens": torch.from_numpy(toks[:, :7])})
    with jmesh:
        _, jcache = jpre.fn(ref, {"tokens": jnp.asarray(toks[:, :7])})
        jnext, _ = jdec.fn(ref, jcache, jnp.asarray(toks[:, 7:8]),
                           jnp.asarray(7, jnp.int32))
    nxt, _ = dec.fn(pieces, cache, torch.from_numpy(toks[:, 7:8]), 7)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

class _IntStepLog(list):
    def append(self, m):
        super().append(dict(m, step=int(m["step"])))


@pytest.mark.parametrize("extra", [[], ["--n-micro", "2",
                                        "--grad-compression"]])
def test_launch_train_losses_equal_reference(tmp_path, monkeypatch, extra):
    """The port's loop started from the reference's PRNGKey(0) weights
    (both fan-in scaled: as drawn, the losses part by 1.1e-4 and 2.2e-4
    at step 6): per-step losses within 1e-4 of the reference's main for
    the same flags."""
    flags = ["--smoke", "--steps", "8", "--log-every", "100"] + extra
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    init = jfault.TrainRunner.__init__

    def int_steps(self, *a, **kw):
        # the reference's log turns every metric into a float, and its
        # main then fails formatting the step with ":5d"
        init(self, *a, **kw)
        self.metrics_log = _IntStepLog()

    monkeypatch.setattr(jfault.TrainRunner, "__init__", int_steps)
    draw = JLMModel.init_params
    monkeypatch.setattr(JLMModel, "init_params",
                        lambda self, key: _scaled_tree(draw(self, key)))
    try:       # the reference's loop installs its guard and leaves it
        want = jtrain.main(flags + ["--ckpt-dir", str(tmp_path / "jax")])
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    jm = JLMModel(jconfigs.get_smoke_config("tinyllama-1.1b"))
    params = params_lib.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0))))
    got = train.run(train.parse_args(
        flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]),
        params)
    assert [int(m["step"]) for m in got] == list(range(1, 9))
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) <= 1e-4, (a, b)


def _final_checkpoint(d, step):
    step_dir = os.path.join(d, f"step_{step}")
    return {f: open(os.path.join(step_dir, f), "rb").read()
            for f in sorted(os.listdir(step_dir)) if f.endswith(".bin")}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-tiny"])
def test_launch_train_resume_bit_exact(tmp_path, arch):
    """--fail-at 5 with checkpoints every 2 steps, then a resume from step
    4: the final checkpoint's bytes equal an uninterrupted run's."""
    flags = ["--device", "cpu", "--smoke", "--arch", arch, "--steps", "8",
             "--ckpt-every", "2", "--log-every", "100"]
    train.main(flags + ["--ckpt-dir", str(tmp_path / "direct")])
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train.main(flags + ["--ckpt-dir", str(tmp_path / "crash"),
                            "--fail-at", "5"])
    resumed = train.main(flags + ["--ckpt-dir", str(tmp_path / "crash")])
    assert [int(m["step"]) for m in resumed] == [5, 6, 7, 8]
    direct = _final_checkpoint(tmp_path / "direct", 8)
    assert direct and direct == _final_checkpoint(tmp_path / "crash", 8)
