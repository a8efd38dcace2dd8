"""The LM serving stack of repro_torch against the JAX reference on the
CPU: configs and ``input_specs``, parameter trees, each datapath module
(cross-attention included; the routed experts are in test_torch_moe.py),
LMModel forward and prefill + decode for the dense, ssm, hybrid, moe,
audio and vlm smoke configs, and the greedy tokens of the serving
example.  A frontend arch's ``prefix_embed`` comes from numpy at 0.1
scale, as the reference's tests draw theirs; ``vlm`` decodes at
``cache_len = frontend_len + t``.

Weights are the reference's (``PRNGKey(0)``) carried across leaf for leaf
by ``params_from_numpy``; inputs come from numpy.  Tolerances: modules in
f32 at 1e-4 (the same f32 arithmetic summed in another order); whole
smoke models in f32 at 1e-4 on the logits, 2e-4 where the reference's
Pallas kernels (interpret mode) stand on one side and the port's plain
versions on the other; bf16 attention at 2e-2 (a few bf16 ulps of the
rounded probabilities and outputs); greedy tokens exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import LMModel as JLMModel
from repro.models.lm import layers as jL
from repro.models.lm import params as jparams
from repro.models.lm import ssm as jssm
from repro.models.lm import transformer as jtransformer
from repro_torch import configs
from repro_torch import kernels
from repro_torch.launch import serve_lm
from repro_torch.models.lm import LMModel, count_params, cross_entropy
from repro_torch.models.lm import layers as L
from repro_torch.models.lm import params as params_lib
from repro_torch.models.lm import ssm

from _archs import PORT_ONLY

torch.set_num_threads(2)

SERVE_ARCHS = ["tinyllama-1.1b", "mamba2-370m", "zamba2-2.7b",
               "grok-1-314b", "kimi-k2-1t-a32b", "whisper-tiny",
               "internvl2-76b"]
FAMILY_ARCHS = ["grok-1-314b", "whisper-tiny", "internvl2-76b"]
# Whisper's logits against the reference: 1e-3.  Its encoder output (the
# decoder's cross-attention memory) reaches |33| on the smoke weights, and
# the decoder's sharp cross-attention carries a relative move of it some
# hundredfold to the logits, in the reference as in the port: two f32
# encoders that sum in another order end a few 1e-4 apart.  The parts are
# held tighter in test_whisper_decoder_on_reference_memory: the memory
# within 4e-6 of its largest value, the decoder fed the reference's memory
# at 1e-4.
MODEL_TOL = {"whisper-tiny": 1e-3}
KERNEL_CTX = {"use_flash": True, "use_kernel": True}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(jparams_tree):
    return params_lib.params_from_numpy(_np_tree(jparams_tree))


def _jcall(fn, table, **static):
    """The reference module ``fn`` jitted with its static ctx entries
    closed over: ``run(p, x, dyn) -> (y, ctx['cache'])`` where ``dyn``
    holds the array entries (positions, cache, cache_len)."""
    def run(p, x, dyn):
        ctx = dict(static, **dyn)
        y = fn(p, x, table=table, ctx=ctx)
        return y, ctx.get("cache")
    return jax.jit(run)


def _materialize(meta, seed):
    return jax.jit(lambda k: jparams.materialize(meta, k))(
        jax.random.PRNGKey(seed))


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_reference(arch):
    """The reference's archs are the port's less ``PORT_ONLY``; each
    equals the reference's on the reference's fields, and the port's own
    fields (explicit hybrid sites and the rest) stay at their defaults."""
    assert jconfigs.ARCH_IDS == [a for a in configs.ARCH_IDS
                                 if a not in PORT_ONLY]
    ref_fields = {f.name for f in dataclasses.fields(jconfigs.ArchConfig)}
    defaults = {f.name: f.default for f in dataclasses.fields(
        configs.ArchConfig) if f.name not in ref_fields}
    assert defaults
    for mine, ref in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.get_smoke_config(arch),
                       jconfigs.get_smoke_config(arch))):
        got = dataclasses.asdict(mine)
        assert {k: got.pop(k) for k in defaults} == defaults
        assert got == dataclasses.asdict(ref)
        assert (mine.hd, mine.d_inner, mine.ssm_heads) == \
            (ref.hd, ref.d_inner, ref.ssm_heads)
    cfg = configs.get_config(arch)
    assert count_params(cfg) == jtransformer.count_params(
        jconfigs.get_config(arch))
    assert count_params(cfg, active_only=True) == jtransformer.count_params(
        jconfigs.get_config(arch), active_only=True)
    ok, why = configs.shape_applicable(cfg, configs.SHAPES["long_500k"])
    assert (ok, why) == jconfigs.shape_applicable(
        jconfigs.get_config(arch), jconfigs.SHAPES["long_500k"])


@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_input_specs_equal_reference(arch, shape):
    mine = configs.input_specs(configs.get_config(arch),
                               configs.SHAPES[shape], batch=3)
    ref = jconfigs.input_specs(jconfigs.get_config(arch),
                               jconfigs.SHAPES[shape], batch=3)
    assert sorted(mine) == sorted(ref)
    for k, spec in ref.items():
        assert mine[k].device.type == "meta"
        assert tuple(mine[k].shape) == tuple(spec.shape), k
        assert mine[k].dtype == params_lib.as_dtype(spec.dtype.name), k


def test_zamba2_param_count():
    assert configs.get_config("zamba2-2.7b").param_count() == 2_422_670_240


def _bf16_smoke(arch):
    return dataclasses.replace(jconfigs.get_smoke_config(arch),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def test_params_from_numpy_bf16_bit_for_bit():
    _check_carried_bit_for_bit("zamba2-2.7b")


@pytest.mark.parametrize("arch,leaves", [
    ("grok-1-314b", ("router", "wg", "wu", "wd")),
    ("kimi-k2-1t-a32b", ("router", "wg", "wu", "wd")),
    ("whisper-tiny", ("enc_layers", "xattn", "xattn_norm")),
    ("internvl2-76b", ("attn", "mlp"))])
def test_params_from_numpy_new_trees_bit_for_bit(arch, leaves):
    """The experts' 3-D weights and router, the encoder stack and the
    cross-attention weights cross leaf for leaf, bf16 bit for bit."""
    paths = _check_carried_bit_for_bit(arch)
    for name in leaves:
        assert any(name in path for path in paths), name


def _check_carried_bit_for_bit(arch):
    jm = JLMModel(_bf16_smoke(arch))
    ref = jax.jit(jm.init_params)(jax.random.PRNGKey(3))
    mine = _port_params(ref)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(list(params_lib.leaves_with_path(mine)))
    for path, leaf in leaves:
        t = mine
        for k in path:
            t = t[k.key]
        a = np.asarray(leaf)
        assert t.dtype == params_lib.as_dtype(a.dtype.name)
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)
    mine_paths = [p for p, _ in params_lib.leaves_with_path(mine)]
    assert sorted(mine_paths) == sorted(
        tuple(k.key for k in p) for p, _ in leaves)
    return mine_paths


def test_quantize_weights_match_reference():
    jm, ref, model, _ = _models("tinyllama-1.1b")
    old = jparams._BFP_MIN_SIZE
    jparams._BFP_MIN_SIZE = 1
    try:
        jq = jax.jit(lambda p: jparams.quantize_weights(
            p, jm.param_meta()))(ref)
    finally:
        jparams._BFP_MIN_SIZE = old
    mine = params_lib.quantize_weights(_port_params(ref), model.param_meta(),
                                       min_size=1)
    carried = _port_params(jq)
    w, cw = mine["layers"]["attn"]["wq"], carried["layers"]["attn"]["wq"]
    assert w.mantissa.dtype == torch.int8 and w.axis == cw.axis == -1
    for path, leaf in params_lib.leaves_with_path(mine):
        other = carried
        for k in path:
            other = other[k]
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(leaf, other), path
        else:
            assert torch.equal(leaf.mantissa, other.mantissa), path
            assert torch.equal(leaf.exponent, other.exponent), path
    assert isinstance(mine["embed"]["table"], torch.Tensor)


# ---------------------------------------------------------------------------
# datapath modules
# ---------------------------------------------------------------------------

def _attn_setup(dtype="float32", kv_cache="compute", bfp=False, seed=0):
    cfg = dataclasses.replace(
        jconfigs.get_smoke_config("tinyllama-1.1b"), param_dtype=dtype,
        compute_dtype=dtype, kv_cache_dtype=kv_cache, bfp_forward=bfp)
    jm = JLMModel(cfg)
    stream = jm.block
    table = stream.tables[0]
    jp = _materialize(stream.metas["attn"], seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    return cfg, jm, table, jp, x


def _jx(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _tx(x, dtype):
    return torch.from_numpy(x).to(params_lib.as_dtype(dtype))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_attention_full(use_flash, dtype, tol):
    cfg, _, table, jp, x = _attn_setup(dtype)
    pos = np.arange(12)[None, :]
    want, _ = _jcall(jL.attention, table, use_flash=use_flash)(
        jp, _jx(x, dtype), {"positions": jnp.asarray(pos)})
    got = L.attention(_port_params(jp), _tx(x, dtype), table=table,
                      ctx={"positions": torch.from_numpy(pos),
                           "use_flash": use_flash})
    assert got.dtype == params_lib.as_dtype(dtype)
    _close(got, want, tol)


@pytest.mark.parametrize("kv_cache", ["compute", "int8"])
def test_attention_prefill_then_decode(kv_cache):
    """Prefill writes the cache (int8: bit-equal codes and f16 scales),
    then decode reads it back, both against the reference."""
    cfg, jm, table, jp, x = _attn_setup(kv_cache=kv_cache, seed=1)
    jcache = jax.tree_util.tree_map(
        lambda a: a[0], jm.init_cache(2, 16)["layers"])
    mine = LMModel(configs.get_smoke_config("tinyllama-1.1b"), "cpu")
    mine.cfg = dataclasses.replace(mine.cfg, kv_cache_dtype=kv_cache)
    cache = {k: v[0] for k, v in mine.init_cache(2, 16)["layers"].items()}
    p = _port_params(jp)
    ctx = {"positions": torch.arange(8)[None, :], "cache": cache,
           "cache_len": 0}
    want, jcache = _jcall(jL.attention, table)(
        jp, jnp.asarray(x[:, :8]), {"positions": jnp.arange(8)[None, :],
                                    "cache": jcache, "cache_len": 0})
    got = L.attention(p, torch.from_numpy(x[:, :8]), table=table, ctx=ctx)
    _close(got, want, 1e-4)
    for k in cache:
        if kv_cache == "int8":
            assert np.array_equal(cache[k].numpy(), np.asarray(jcache[k])), k
        else:
            _close(cache[k], jcache[k], 1e-5)
    jdecode = _jcall(jL.attention, table, mode="decode")
    for t in (8, 9):
        ctx.update(mode="decode", cache_len=t,
                   positions=torch.full((2, 1), t))
        want, jcache = jdecode(jp, jnp.asarray(x[:, t:t + 1]), {
            "positions": jnp.full((2, 1), t), "cache": jcache,
            "cache_len": jnp.int32(t)})
        got = L.attention(p, torch.from_numpy(x[:, t:t + 1]), table=table,
                          ctx=ctx)
        _close(got, want, 1e-4)


@pytest.mark.parametrize("mode", ["full", "decode"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cross_attention(dtype, tol, mode):
    """Whisper's decoder cross-attention over the encoder memory (B, S,
    D): no RoPE, not causal, as at prefill and at a decode step."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config("whisper-tiny"),
                              param_dtype=dtype, compute_dtype=dtype)
    stream = JLMModel(cfg).block
    table = stream.tables[0]
    jp = _materialize(stream.metas["xattn"], 4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1 if mode == "decode" else 7,
                             cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)) \
        .astype(np.float32)
    want, _ = _jcall(jL.cross_attention, table, mode=mode)(
        jp, _jx(x, dtype), {"memory": _jx(mem, dtype)})
    got = L.cross_attention(_port_params(jp), _tx(x, dtype), table=table,
                            ctx={"memory": _tx(mem, dtype), "mode": mode})
    assert got.dtype == params_lib.as_dtype(dtype)
    _close(got, want, tol)


@pytest.mark.parametrize("bfp", [False, True])
def test_mlps_norms_embed_head(bfp):
    table = {"compute_dtype": "float32"}
    if bfp:
        table.update(bfp=True, bfp_block=32, bfp_mantissa=10)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7))
    metas = {"glu_mlp": jL.glu_mlp_meta(64, 96, "float32"),
             "mlp": jL.mlp_meta(64, 96, "float32"),
             "lm_head": jL.lm_head_meta(64, 50, "float32"),
             "rmsnorm": jL.rmsnorm_meta(64, "float32"),
             "layernorm": jL.layernorm_meta(64, "float32"),
             "embed": jL.embed_meta(50, 64, "float32")}
    jp = _materialize(metas, 2)
    # non-zero biases and shifts
    jp["mlp"] = dict(jp["mlp"], b1=jp["mlp"]["b1"] + 0.1,
                     b2=jp["mlp"]["b2"] - 0.2)
    jp["layernorm"] = dict(jp["layernorm"], bias=jp["layernorm"]["bias"] + 1)

    def outputs(mod, p, x, toks):
        out = {n: getattr(mod, n)(p[n], x, table=table)
               for n in ("glu_mlp", "mlp", "lm_head", "rmsnorm")}
        out["layernorm"] = mod.layernorm(p["layernorm"], x * 3 + 1)
        out["embed"] = mod.embed(p["embed"], toks, table=table)
        return out

    want = jax.jit(lambda p, x, t: outputs(jL, p, x, t))(
        jp, jnp.asarray(x), jnp.asarray(toks))
    got = outputs(L, _port_params(jp), torch.from_numpy(x),
                  torch.from_numpy(toks))
    for n in want:
        _close(got[n], want[n], 0 if n == "embed" else 1e-4)


def test_rope():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 3, 24)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9))
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-4)


def _ssm_setup(seed=0, bfp=False):
    cfg = dataclasses.replace(jconfigs.get_smoke_config("mamba2-370m"),
                              bfp_forward=bfp)
    stream = JLMModel(cfg).block
    table = stream.tables[0]
    jp = _materialize(stream.metas["ssm"], seed)
    # non-trivial dt bias, decay and skip
    jp = dict(jp, dt_bias=jp["dt_bias"] - 1.0, A_log=jp["A_log"] + 0.3,
              D=jp["D"] * 0.5)
    x = np.random.default_rng(seed).standard_normal((2, 16, cfg.d_model)) \
        .astype(np.float32)
    return cfg, table, jp, x


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bfp", [False, True])
def test_mamba2_block_full(use_kernel, bfp):
    _, table, jp, x = _ssm_setup(bfp=bfp)
    want, _ = _jcall(jssm.mamba2_block, table, use_kernel=use_kernel)(
        jp, jnp.asarray(x), {})
    got = ssm.mamba2_block(_port_params(jp), torch.from_numpy(x),
                           table=table, ctx={"use_kernel": use_kernel})
    _close(got, want, 1e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_prefill_state_then_decode(use_kernel):
    """Prefill hands decode the conv tail and the final SSM state; with
    use_kernel the port takes them from K5's scan."""
    cfg, table, jp, x = _ssm_setup(seed=2)
    d_conv = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    shapes = {"conv": (2, cfg.conv_width - 1, d_conv),
              "ssm": (2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)}
    jcache = {k: jnp.zeros(s) for k, s in shapes.items()}
    ctx = {"cache": {k: torch.zeros(s) for k, s in shapes.items()},
           "use_kernel": use_kernel}
    p = _port_params(jp)
    want, jcache = _jcall(jssm.mamba2_block, table, use_kernel=use_kernel)(
        jp, jnp.asarray(x[:, :8]), {"cache": jcache})
    _close(ssm.mamba2_block(p, torch.from_numpy(x[:, :8]), table=table,
                            ctx=ctx), want, 1e-4)
    for k in shapes:
        _close(ctx["cache"][k], jcache[k], 1e-4)
    jdecode = _jcall(jssm.mamba2_block, table, mode="decode")
    ctx["mode"] = "decode"
    for t in range(8, 11):
        want, jcache = jdecode(jp, jnp.asarray(x[:, t:t + 1]),
                               {"cache": jcache})
        _close(ssm.mamba2_block(p, torch.from_numpy(x[:, t:t + 1]),
                                table=table, ctx=ctx), want, 1e-4)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference model, its PRNGKey(0) params, the port's model, the same
    params carried across), built once per architecture."""
    jm = JLMModel(jconfigs.get_smoke_config(arch))
    ref = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    return jm, ref, LMModel(configs.get_smoke_config(arch), "cpu"), \
        _port_params(ref)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape) \
        .astype(np.int32)


def _prefix(cfg, batch, seed=9):
    """The frontend stub's frames for both packages (numpy, 0.1 scale):
    ({"prefix_embed": jax array}, {"prefix_embed": tensor}), or two empty
    dicts for an arch without a frontend."""
    if cfg.frontend == "none":
        return {}, {}
    pf = np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.1
    return {"prefix_embed": jnp.asarray(pf)}, \
        {"prefix_embed": torch.from_numpy(pf)}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_forward_matches_reference(arch):
    jm, ref, model, p = _models(arch)
    toks = _tokens(model.cfg, (2, 16))
    jkw, kw = _prefix(model.cfg, 2)
    got = model.forward(p, torch.from_numpy(toks), **kw)
    assert tuple(got.shape) == (2, 16, model.cfg.vocab)
    _close(got, jax.jit(jm.forward)(ref, jnp.asarray(toks), **jkw),
           MODEL_TOL.get(arch, 1e-4))


def test_whisper_decoder_on_reference_memory(monkeypatch):
    """The encoder's output within 4e-6 of its largest value, and the
    decoder, fed the reference's encoder output, at the model tolerance."""
    jm, ref, model, p = _models("whisper-tiny")
    toks = _tokens(model.cfg, (2, 16))
    jkw, kw = _prefix(model.cfg, 2)
    jlogits, jcache = jax.jit(functools.partial(
        jm.forward, cache_out=True, max_len=16))(ref, jnp.asarray(toks), **jkw)
    _, cache = model.forward(p, torch.from_numpy(toks), cache_out=True,
                             max_len=16, **kw)
    jmem = np.array(jcache["memory"])
    _close(cache["memory"], jmem, 4e-6 * float(np.abs(jmem).max()))
    monkeypatch.setattr(model, "_encode",
                        lambda params, pe, remat=False: torch.from_numpy(jmem))
    _close(model.forward(p, torch.from_numpy(toks), **kw), jlogits, 1e-4)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 8 tokens with the kernels' routes on both sides (JAX:
    Pallas in interpret mode), then 4 decode steps."""
    jm, ref, model, p = _models(arch)
    toks = _tokens(model.cfg, (2, 12), seed=2)
    jkw, kw = _prefix(model.cfg, 2)
    start = serve_lm.decode_start(model.cfg, 8)     # vlm: after the prefix
    max_len = start + 4
    jlogits, jcache = jax.jit(functools.partial(
        jm.forward, cache_out=True, max_len=max_len,
        ctx_extra=dict(KERNEL_CTX)))(ref, jnp.asarray(toks[:, :8]), **jkw)
    kernels.reset_launch_counts()
    _, logits, cache = serve_lm.prefill(model, p, torch.from_numpy(toks[:, :8]),
                                        max_len, **kw)
    tol = MODEL_TOL.get(arch, 2e-4)
    _close(logits, jlogits, tol)
    assert sum(kernels.launch_counts().values()) == 0   # plain on the CPU
    jstep = jax.jit(jm.decode_step)
    for t in range(8, 12):
        pos = start + t - 8
        jl, jcache = jstep(ref, jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(pos))
        lg, cache = model.decode_step(p, torch.from_numpy(toks[:, t:t + 1]),
                                      cache, pos)
        _close(lg, jl, tol)


def _greedy_tokens_equal_reference(arch):
    """The reference example's prefill + greedy decode (examples/serve_lm.py)
    on the same weights and prompts gives the same 10 tokens."""
    jm, ref, model, p = _models(arch)
    prompts = _tokens(model.cfg, (3, 8), seed=5)
    jkw, kw = _prefix(model.cfg, 3)
    n_tokens = 10
    start = serve_lm.decode_start(model.cfg, 8)
    max_len = start + n_tokens

    @jax.jit
    def jprefill(params, toks, jkw):
        logits, cache = jm.forward(params, toks, cache_out=True,
                                   max_len=max_len, **jkw)
        return jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32), cache

    @jax.jit
    def jstep(params, tok, cache, pos):
        logits, cache = jm.decode_step(params, tok[:, None], cache, pos)
        return jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32), cache

    tok, jcache = jprefill(ref, jnp.asarray(prompts), jkw)
    want = [tok]
    for pos in range(start, start + n_tokens - 1):
        tok, jcache = jstep(ref, tok, jcache, pos)
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], 1)

    tok, _, cache = serve_lm.prefill(model, p, torch.from_numpy(prompts),
                                     max_len, **kw)
    rest, _, _ = serve_lm.decode(model, p, tok, cache, start, n_tokens - 1)
    got = torch.cat([tok[:, None], rest], 1).numpy()
    assert np.array_equal(got, want)


def test_serve_lm_greedy_tokens_equal_reference():
    _greedy_tokens_equal_reference("zamba2-2.7b")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_lm_greedy_tokens_equal_reference_by_family(arch):
    """One arch of each family this slice added: moe, audio, vlm."""
    _greedy_tokens_equal_reference(arch)


def test_serve_lm_main_on_cpu(capsys):
    gen = serve_lm.main(["--device", "cpu", "--arch", "mamba2-370m",
                         "--batch", "2", "--tokens", "4", "--bfp-weights"])
    assert tuple(gen.shape) == (2, 4)
    assert "serve_lm OK" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_serve_lm_main_frontend_arch_on_cpu(capsys, arch):
    gen = serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                         "--tokens", "4"])
    assert tuple(gen.shape) == (2, 4)
    assert "serve_lm OK" in capsys.readouterr().out


def test_decode_start_and_prefix_spec():
    vlm = configs.get_smoke_config("internvl2-76b")
    audio = configs.get_smoke_config("whisper-tiny")
    assert serve_lm.decode_start(vlm, 5) == vlm.frontend_len + 5
    assert serve_lm.decode_start(audio, 5) == 5
    assert serve_lm.prefix_embed_for(configs.get_smoke_config(
        "tinyllama-1.1b"), 2, torch.Generator()) is None
    pf = serve_lm.prefix_embed_for(audio, 3, torch.Generator().manual_seed(0))
    assert tuple(pf.shape) == (3, audio.frontend_len, audio.d_model)
    assert pf.dtype == torch.float32 and float(pf.abs().max()) < 1.0


def test_audio_forward_needs_prefix_embed():
    model = LMModel(configs.get_smoke_config("whisper-tiny"), "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="prefix_embed"):
        model.forward(params, torch.zeros((1, 4), dtype=torch.int64))


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b",
                                  "whisper-tiny", "internvl2-76b"])
def test_cache_meta_equals_reference(arch):
    """init_cache's leaves (the encoder memory included) have the
    reference's shapes and types."""
    jm, _, model, _ = _models(arch)
    want = jax.eval_shape(lambda: jm.init_cache(2, 10))
    got = model.init_cache(2, 10)
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(paths) == len(list(params_lib.leaves_with_path(got)))
    for path, leaf in paths:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert t.dtype == params_lib.as_dtype(leaf.dtype.name), path


def test_cross_entropy():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, (2, 6)).astype(np.int32)
    _close(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
           jtransformer.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels)), 1e-5)


def test_hybrid_shares_one_attention_copy():
    cfg = configs.get_smoke_config("zamba2-2.7b")
    model = LMModel(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    assert params["shared_attn"]["shared_attn"]["wq"].dim() == 3
    assert params["layers"]["ssm"]["in_proj"].shape[0] == cfg.n_layers
    cache = model.init_cache(2, 8)
    assert cache["shared_attn"]["k"].shape[0] == cfg.n_layers // cfg.attn_every
