"""The port's mesh pipeline (``repro_torch.runtime.pipeline``) against
the JAX package's on the CPU: ``split_stages`` and ``microbatch`` value
for value, and ``pipeline_apply`` on a (4, 2) host mesh of ``"cpu"``
slots against the reference's ``lax.scan`` of the same layer and its
``jax.grad``, against the reference's own ``pipeline_apply`` at S = 1 (in
process) and at S = 4 (in a subprocess with 8 forced host devices, as
tests/test_distributed.py runs it), and over an InternLM2 smoke stack.

Inputs and weights come from numpy with a seed (the InternLM2 stack's
from the reference's ``PRNGKey(0)`` init, carried across by
``params_from_numpy``, its attention projections at their true fan-in on
both sides).  Bounds are the reference test's: forward 1e-5,
gradients 1e-4 (absolute, on O(1) values; the InternLM2 stack's relative
to the largest value of each tensor).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.models.lm import LMModel as JLMModel
from repro.models.lm import params as jparams
from repro.runtime import pipeline as jpipeline
from repro_torch import configs
from repro_torch.core import tree as tree_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LMModel
from repro_torch.models.lm import params as params_lib
from repro_torch.runtime import pipeline

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
L, D, M, MB, SEQ = 8, 16, 4, 2, 8
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _toy(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((M, MB, SEQ, D)).astype(np.float32)
    return params, x


def _torch_layer(lp, h):
    return torch.tanh(h @ lp["w"] + lp["b"])


def _jax_layer(lp, h):
    return jnp.tanh(h @ lp["w"] + lp["b"])


def _scan_ref(params, x):
    """The reference's sequential stack: ``lax.scan`` over the layers,
    vmapped over the microbatches."""
    def one(xm):
        return jax.lax.scan(lambda c, lp: (_jax_layer(lp, c), None), xm,
                            params)[0]
    return jax.vmap(one)(x)


def _leaf_params(np_params):
    return {k: torch.tensor(v, requires_grad=True)
            for k, v in np_params.items()}


def _mesh(S):
    return make_host_mesh((S, 2) if S > 1 else (1, 1), ("stage", "mdl"),
                          device="cpu")


def _port_run(np_params, np_x, S, *, remat=True, x_grad=False):
    """(y, gradients of sum(y^2) w.r.t. the staged params restaged to
    (L, ...), and w.r.t. x or None)."""
    params = _leaf_params(np_params)
    staged = pipeline.split_stages(params, S)
    x = torch.tensor(np_x, requires_grad=x_grad)
    y = pipeline.pipeline_apply(_mesh(S), "stage", _torch_layer, staged, x,
                                remat=remat)
    wrt = [params["w"], params["b"]] + ([x] if x_grad else [])
    grads = torch.autograd.grad((y ** 2).sum(), wrt)
    g = {"w": grads[0].numpy(), "b": grads[1].numpy()}
    return y.detach().numpy(), g, grads[2].numpy() if x_grad else None


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------------------------
# split_stages / microbatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_split_stages_equals_reference(S):
    params, _ = _toy()
    got = pipeline.split_stages({k: torch.tensor(v) for k, v in
                                 params.items()}, S)
    want = jpipeline.split_stages({k: jnp.asarray(v) for k, v in
                                   params.items()}, S)
    for k in params:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
def test_microbatch_equals_reference(n_micro):
    x = np.random.default_rng(1).standard_normal((8, SEQ, D)).astype(
        np.float32)
    got = pipeline.microbatch(torch.tensor(x), n_micro)
    want = jpipeline.microbatch(jnp.asarray(x), n_micro)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_and_microbatch_raise_on_remainders():
    with pytest.raises(ValueError, match="stages"):
        pipeline.split_stages({"w": torch.zeros(6, 2)}, 4)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.microbatch(torch.zeros(6, 2), 4)


def test_pipeline_apply_raises_on_stage_mismatch():
    params, x = _toy()
    staged = pipeline.split_stages(_leaf_params(params), 2)
    with pytest.raises(ValueError, match="stages"):
        pipeline.pipeline_apply(_mesh(4), "stage", _torch_layer, staged,
                                torch.tensor(x))
    with pytest.raises(ValueError, match="no axis"):
        pipeline.pipeline_apply(_mesh(4), "pipe", _torch_layer, staged,
                                torch.tensor(x))


# ---------------------------------------------------------------------------
# pipeline_apply against the scan and against the reference's pipeline
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scan_value_and_grad(seed):
    """The reference's forward and gradient of sum(y^2) w.r.t. the params
    and x, on ``_toy(seed)``."""
    params, x = _toy(seed)

    def loss(p, xx):
        y = _scan_ref(p, xx)
        return jnp.sum(y ** 2), y

    (_, y), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return y, g, gx


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_fwd_and_grad_match_scan(S):
    """The reference's test_fwd_and_grad_match_scan on the port, S = 4 on
    the (4, 2) mesh as there, and the other stage counts."""
    params, x = _toy()
    y, g, _ = _port_run(params, x, S)
    y_ref, g_ref, _ = _scan_value_and_grad(0)
    assert _max_err(y, y_ref) < FWD_TOL
    err = max(_max_err(g[k], g_ref[k]) for k in params)
    assert err < GRAD_TOL, err


def test_remat_on_equals_off():
    params, x = _toy(3)
    on = _port_run(params, x, 4, remat=True)
    off = _port_run(params, x, 4, remat=False)
    np.testing.assert_array_equal(on[0], off[0])
    for k in params:
        assert _max_err(on[1][k], off[1][k]) < GRAD_TOL


def test_grad_wrt_x_matches_scan():
    params, x = _toy()
    _, _, gx = _port_run(params, x, 4, x_grad=True)
    assert _max_err(gx, _scan_value_and_grad(0)[2]) < GRAD_TOL


def test_s1_equals_reference_pipeline_apply():
    """S = 1 against the reference's own pipeline_apply on a one-device
    mesh, in process: forward and gradients."""
    params, x = _toy(7)
    y, g, _ = _port_run(params, x, 1)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("stage", "mdl"))
    jx = jnp.asarray(x)

    def ref(p):
        staged = jpipeline.split_stages(p, 1)
        return jpipeline.pipeline_apply(jmesh, "stage", _jax_layer, staged,
                                        jx)

    (_, y_ref), g_ref = jax.value_and_grad(
        lambda p: (jnp.sum(ref(p) ** 2), ref(p)), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    assert _max_err(y, y_ref) < FWD_TOL
    for k in params:
        assert _max_err(g[k], g_ref[k]) < GRAD_TOL


def test_s4_equals_reference_pipeline_apply(tmp_path):
    """S = 4 against the reference's own pipeline_apply on a (4, 2) mesh
    of 8 forced host devices, run in a subprocess that hands back its
    forward and its gradients w.r.t. the staged params as .npy."""
    params, x = _toy(11)
    for k, v in params.items():
        np.save(tmp_path / f"p_{k}.npy", v)
    np.save(tmp_path / "x.npy", x)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import sys
        sys.path.insert(0, {SRC!r})
        import jax
        import jax.numpy as jnp
        import numpy as np
        from repro.launch.mesh import make_mesh
        from repro.runtime.pipeline import pipeline_apply, split_stages
        d = {str(tmp_path)!r}
        mesh = make_mesh((4, 2), ("stage", "mdl"))
        p = {{k: jnp.asarray(np.load(f"{{d}}/p_{{k}}.npy")) for k in "wb"}}
        x = jnp.asarray(np.load(f"{{d}}/x.npy"))
        layer = lambda lp, h: jnp.tanh(h @ lp["w"] + lp["b"])
        staged = split_stages(p, 4)
        def loss(s):
            y = pipeline_apply(mesh, "stage", layer, s, x)
            return jnp.sum(y ** 2), y
        (_, y), g = jax.value_and_grad(loss, has_aux=True)(staged)
        np.save(f"{{d}}/y.npy", np.asarray(y))
        for k in "wb":
            np.save(f"{{d}}/g_{{k}}.npy", np.asarray(g[k]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    y, g, _ = _port_run(params, x, 4)
    assert _max_err(y, np.load(tmp_path / "y.npy")) < FWD_TOL
    for k in params:
        g_ref = np.load(tmp_path / f"g_{k}.npy")       # (S, L/S, ...)
        assert g_ref.shape[:2] == (4, L // 4)
        assert _max_err(g[k], g_ref.reshape(g[k].shape)) < GRAD_TOL


# ---------------------------------------------------------------------------
# an InternLM2 smoke stack (8 layers, f32) in 4 stages
# ---------------------------------------------------------------------------

def test_internlm2_stack_matches_reference_scan():
    """The port's train-mode decoder layer (``LMModel.layer_fn``) over
    the reference's weights in 4 stages, against a ``lax.scan`` of the
    reference's block over the same weights: forward, and the gradients
    of sum(y^2) w.r.t. the layers' params and x."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("internlm2-1.8b"),
                               n_layers=8)
    cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                              n_layers=8)
    jm = JLMModel(jcfg)
    drawn = jparams.materialize(jm.param_meta(),
                                jax.random.PRNGKey(0))["layers"]
    # the attention projections at their true fan-in on both sides
    # (params.scale_attention_to_fan_in): the reference's init makes every
    # softmax near one-hot, and two f32 stacks then end far apart
    layers = params_lib.scale_attention_to_fan_in(
        params_lib.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, drawn)))
    jlayers = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     layers)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 2, 16, cfg.d_model))).astype(np.float32)

    fn = jm.block.fn()

    def jlayer(lp, h):
        ctx = {"positions": jnp.arange(h.shape[1], dtype=jnp.int32)[None],
               "mode": "full", "interpret": True,
               "compute_dtype": jnp.float32, "cache_len": 0}
        return fn(lp, h, ctx)[0]

    def ref(p, xx):
        return jax.vmap(lambda xm: jax.lax.scan(
            lambda c, lp: (jlayer(lp, c), None), xm, p)[0])(xx)

    def loss(p, xx):
        y = ref(p, xx)
        return jnp.sum(y ** 2), y

    (_, y_ref), (g_ref, gx_ref) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jlayers, jnp.asarray(x))
    y_ref = np.asarray(y_ref)

    model = LMModel(cfg, "cpu")
    layers = tree_lib.tree_map(lambda t: t.requires_grad_(True), layers)
    xt = torch.tensor(x, requires_grad=True)
    y = pipeline.pipeline_apply(_mesh(4), "stage", model.layer_fn(),
                                pipeline.split_stages(layers, 4), xt)
    scale = float(np.max(np.abs(y_ref)))
    assert _max_err(y.detach().numpy(), y_ref) < FWD_TOL * scale
    flat = tree_lib.leaves(layers)
    grads = torch.autograd.grad((y ** 2).sum(), flat + [xt])
    for got, want in zip(grads[:-1], jax.tree_util.tree_leaves(g_ref),
                         strict=True):
        want = np.asarray(want)
        tol = GRAD_TOL * max(float(np.max(np.abs(want))), 1e-30)
        assert _max_err(got.numpy(), want) <= tol
    gx_ref = np.asarray(gx_ref)
    assert _max_err(grads[-1].numpy(), gx_ref) < GRAD_TOL * float(
        np.max(np.abs(gx_ref)))


def test_bfp_weight_leaves_are_indexed_per_layer():
    """Staged params holding BFP leaves (int8 mantissas and block
    exponents, the serving weight storage): the pipeline indexes a
    layer's mantissa and exponent together, as ``transformer._index``
    does, and its forward equals the layer loop over the same leaves."""
    from repro_torch.core import bfp
    from repro_torch.models.lm import transformer

    cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                              n_layers=4)
    model = LMModel(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    layers = params_lib.quantize_weights(
        params["layers"], model.param_meta()["layers"], min_size=0)
    assert any(isinstance(v, bfp.BFPTensor)
               for v in tree_lib.leaves(layers, is_leaf=lambda t: isinstance(
                   t, bfp.BFPTensor)))
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (4, 2, 8, cfg.d_model)).astype(np.float32))
    fn = model.layer_fn()
    with torch.no_grad():
        y = pipeline.pipeline_apply(_mesh(2), "stage", fn,
                                    pipeline.split_stages(layers, 2), x)
        want = []
        for m in range(x.shape[0]):
            h = x[m]
            for i in range(cfg.n_layers):
                h = fn(transformer._index(layers, i), h)
            want.append(h)
    np.testing.assert_array_equal(y.numpy(), torch.stack(want).numpy())
