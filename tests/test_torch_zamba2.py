"""Zamba2-7B's stack in the port against the benchmark's plain reference
(``perfbench/plain/zamba2.py``), and that reference against
transformers' ``Zamba2ForCausalLM``, on the CPU at a small
Zamba2-7B-shaped config: d_model 64, 4 heads of 32 over the 128-wide
concat(hidden, embeddings), 9 Mamba2 layers with sites (2, 4, 7) so the
two shared blocks go 0, 1, 0, two SSM groups, chunk 8, adapter rank 4.

Tolerances, over L = the reference's largest |logit|: the port in f32
against the reference at 1e-4 (the same f32 arithmetic in another order
and grouping; measured about 5e-6); the port in bf16 at 0.15 (bf16
storage of every activation and of the residual stream: the reference
with its own activations rounded to bf16's 7 mantissa bits reads about
0.06 on these weights, the port 0.06-0.09, and a dropped adapter term
0.95); the reference against transformers in f32 at 1e-4.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.families.lm import arch_config, nest  # noqa: E402
from perfbench.plain import zamba2 as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_plain, wgmma_geometry)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_reference  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models.lm import LMModel  # noqa: E402

torch.set_num_threads(2)

SITES = [2, 4, 7]
TINY = dict(
    hidden_size=64, attention_hidden_size=128, attention_head_dim=32,
    kv_channels=16, num_attention_heads=4, num_key_value_heads=4,
    num_query_groups=4, intermediate_size=128, ffn_hidden_size=128,
    vocab_size=256, num_hidden_layers=9, hybrid_layer_ids=SITES,
    layers_block_type=["hybrid" if i in SITES else "mamba"
                       for i in range(9)],
    n_mamba_heads=8, mamba_headdim=16, mamba_d_state=16, mamba_ngroups=2,
    chunk_size=8, adapter_rank=4, max_position_embeddings=64)
KERNEL_CTX = {"use_flash": True, "use_kernel": True}


def tiny_config(dtype="float32"):
    cfg = json.loads((REPO / "perfbench" / "configs" /
                      "zamba2_7b.json").read_text())
    cfg.update(TINY, name="zamba2-7b-smoke", dtype=dtype)
    return cfg


def _gap(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


def _tokens(b, n, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (b, n)))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_published_config():
    cfg = configs.get_config("zamba2-7b")
    assert cfg.param_count() == 7_356_749_648
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.attn_in, cfg.d_inner,
            cfg.ssm_heads) == (81, 3584, 224, 7168, 7168, 112)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77)
    assert cfg.num_mem_blocks == 2 and cfg.adapter_rank == 128
    assert math.isclose(cfg.sm_scale, 112 ** -0.5)
    # the benchmark's file of the published keys gives the same config
    bench = json.loads((REPO / "perfbench" / "configs" /
                        "zamba2_7b.json").read_text())
    assert arch_config(dict(bench, name="zamba2-7b")) == dataclasses.replace(
        cfg, remat=False)


def test_smoke_config_is_the_tiny_config():
    assert arch_config(tiny_config()) == configs.get_smoke_config(
        "zamba2-7b")


def test_param_tree_is_the_references_binding_names():
    model = LMModel(configs.get_config("zamba2-7b"), "meta")
    flat = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = tuple(v.shape)

    walk(model.param_meta(), ())
    bench = json.loads((REPO / "perfbench" / "configs" /
                        "zamba2_7b.json").read_text())
    assert flat == ref.param_shapes(bench)
    cache = model.cache_meta(8, 3848)
    assert tuple(cache["shared_attn"]["k"].shape) == (13, 8, 3848, 32, 224)
    assert tuple(cache["layers"]["ssm"].shape) == (81, 8, 112, 64, 64)


# ---------------------------------------------------------------------------
# the port against the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.15)])
@pytest.mark.parametrize("kernels", [False, True])
def test_prefill_logits_match_reference(dtype, tol, kernels):
    cfg = tiny_config(dtype)
    p = ref.make_params(cfg, 3, "cpu")
    model = LMModel(arch_config(cfg), "cpu")
    toks = _tokens(2, 24)
    got = model.forward(nest(p), toks, mode="serve",
                        ctx_extra=KERNEL_CTX if kernels else None)
    assert got.dtype == torch.float32
    assert _gap(got, ref.forward(cfg, p, toks)) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.15)])
def test_prefill_and_decode_match_full_forward(dtype, tol):
    """``serve_lm.prefill`` and 4 greedy decode steps through the caches
    (13 sites' K/V here 3, every layer's conv and SSM state), against
    the reference's full forward over the prompt and those tokens."""
    cfg = tiny_config(dtype)
    p = ref.make_params(cfg, 5, "cpu")
    model = LMModel(arch_config(cfg), "cpu")
    toks = _tokens(2, 16, seed=1)
    tok, logits, cache = serve_lm.prefill(model, nest(p), toks, 20)
    assert logits.shape == (2, 16, 256)
    rest, lg, cache = serve_lm.decode(model, nest(p), tok, cache, 16, 4)
    full = torch.cat([toks, tok[:, None].long(), rest[:, :3].long()], 1)
    want = ref.forward(cfg, p, full, positions=range(15, 20))
    got = torch.cat([logits[:, -1:], lg], 1)
    assert _gap(got, want) < tol


def test_alternating_blocks_and_adapters_are_seen():
    """The tolerance sees the structure: dropping the sites' adapter
    term, or running block 0 at every site in place of the two blocks in
    turn, reads far outside it."""
    cfg = tiny_config()
    p = ref.make_params(cfg, 3, "cpu")
    toks = _tokens(1, 16)
    want = ref.forward(cfg, p, toks)
    no_adapter = dict(p, **{"sites/adapter/b":
                            torch.zeros_like(p["sites/adapter/b"])})
    model = LMModel(arch_config(cfg), "cpu")
    assert _gap(model.forward(nest(no_adapter), toks, mode="serve"),
                want) > 0.1
    one_block = dict(p)
    for k in [k for k in p if k.startswith("mem_blocks/")]:
        one_block[k] = p[k][[0, 0]]
    assert _gap(model.forward(nest(one_block), toks, mode="serve"),
                want) > 0.1


# ---------------------------------------------------------------------------
# the plain reference against transformers' Zamba2
# ---------------------------------------------------------------------------

def _hf_model(cfg, p, chunk):
    transformers = pytest.importorskip("transformers")
    m = ref.dims(cfg)
    hcfg = transformers.Zamba2Config(
        vocab_size=m["vocab"], hidden_size=m["d"],
        num_hidden_layers=m["layers"],
        layers_block_type=cfg["layers_block_type"],
        num_attention_heads=m["heads"], num_key_value_heads=m["kv_heads"],
        intermediate_size=m["f"], mamba_d_state=m["n"],
        mamba_d_conv=m["w"], mamba_expand=2, mamba_ngroups=m["g"],
        n_mamba_heads=m["ssm_heads"], chunk_size=chunk,
        adapter_rank=m["rank"], num_mem_blocks=m["blocks"],
        use_shared_attention_adapter=False, use_shared_mlp_adapter=True,
        use_mem_rope=True, rope_theta=cfg["rope_theta"],
        hidden_act="gelu", rms_norm_eps=cfg["rms_norm_eps"],
        max_position_embeddings=64, tie_word_embeddings=True,
        # the torch path clamps dt below at time_step_min; out of reach
        time_step_min=1e-12, use_mem_eff_path=False,
        attn_implementation="eager", torch_dtype=torch.float32)
    hf = transformers.Zamba2ForCausalLM(hcfg).eval()
    model = hf.model
    sd = {}
    sd["model.embed_tokens.weight"] = p["embed/table"]
    sd["model.final_layernorm.weight"] = p["final_norm/scale"]
    sites = {i: s for s, i in enumerate(cfg["hybrid_layer_ids"])}
    for i in range(m["layers"]):
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in sites else "")
        sd[pre + "input_layernorm.weight"] = p["layers/ssm_norm/scale"][i]
        mm = pre + "mamba."
        sd[mm + "in_proj.weight"] = p["layers/ssm/in_proj"][i].t()
        sd[mm + "conv1d.weight"] = p["layers/ssm/conv_w"][i].t()[:, None]
        sd[mm + "conv1d.bias"] = p["layers/ssm/conv_b"][i]
        for k in ("dt_bias", "A_log", "D"):
            sd[mm + k] = p[f"layers/ssm/{k}"][i]
        sd[mm + "norm.weight"] = p["layers/ssm/norm_scale"][i]
        sd[mm + "out_proj.weight"] = p["layers/ssm/out_proj"][i].t()
        if i not in sites:
            continue
        s = sites[i]
        b = s % m["blocks"]
        sd[f"model.layers.{i}.linear.weight"] = p["sites/linear/w"][s].t()
        st = f"model.layers.{i}.shared_transformer."
        sd[st + "input_layernorm.weight"] = p["mem_blocks/attn_norm/scale"][b]
        for n in ("q", "k", "v"):
            w = p[f"mem_blocks/attn/w{n}"][b]
            sd[st + f"self_attn.{n}_proj.weight"] = w.reshape(
                w.shape[0], -1).t()
        wo = p["mem_blocks/attn/wo"][b]
        sd[st + "self_attn.o_proj.weight"] = wo.reshape(-1,
                                                        wo.shape[-1]).t()
        sd[st + "pre_ff_layernorm.weight"] = p["mem_blocks/mlp_norm/scale"][b]
        sd[st + "feed_forward.gate_up_proj.weight"] = torch.cat(
            [p["mem_blocks/mlp/wg"][b], p["mem_blocks/mlp/wu"][b]], 1).t()
        sd[st + "feed_forward.down_proj.weight"] = \
            p["mem_blocks/mlp/wd"][b].t()
        ad = st + f"feed_forward.gate_up_proj_adapter_list.{s}."
        sd[ad + "0.weight"] = p["sites/adapter/a"][s].t()
        sd[ad + "1.weight"] = p["sites/adapter/b"][s].t()
    own = hf.state_dict()
    for k, v in sd.items():
        assert own[k].shape == v.shape, k
    missing, _ = hf.load_state_dict(sd, strict=False)
    # left out: the tied head, and the shared blocks' other sites' copies
    # of the same modules
    assert all(k == "lm_head.weight" or ".shared_transformer." in k
               for k in missing), missing
    assert torch.equal(hf.lm_head.weight, p["embed/table"])
    del model
    return hf


def test_reference_matches_transformers_zamba2():
    """transformers' torch path of the Mamba2 mixer (the one without
    mamba_ssm's kernels) carries the chunk-end states wrongly when a
    sequence spans chunks (``torch_forward`` sums ``decay_chunk`` times
    the states over the target chunk, ``.sum(dim=2)``, not the source),
    so it runs here with one chunk of the whole sequence: the chunk is a
    tiling of the scan, and the reference's own chunked scan is held to
    the sequential recurrence across chunks (next test)."""
    cfg = tiny_config()
    p = ref.make_params(cfg, 3, "cpu")
    toks = _tokens(2, 24, seed=2)
    hf = _hf_model(cfg, p, chunk=24)
    with torch.no_grad():
        want = hf(input_ids=toks, use_cache=False).logits
    assert _gap(ref.forward(cfg, p, toks), want) < 1e-4


def test_reference_chunk_does_not_change_the_scan():
    """The reference's chunked SSD at 8 and at the whole sequence (the
    published chunk is a tiling, not part of the function), and its scan
    against the sequential recurrence across three chunks."""
    cfg = tiny_config()
    p = ref.make_params(cfg, 3, "cpu")
    toks = _tokens(1, 24, seed=3)
    a = ref.forward(cfg, p, toks)
    b = ref.forward(dict(cfg, chunk_size=24), p, toks)
    assert _gap(a, b) < 1e-5
    rng = np.random.default_rng(7)
    x, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((1, 24, 4, 8), (1, 24, 2, 8), (1, 24, 2, 8)))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((1, 24, 4)).astype(np.float32)))
    A = -torch.arange(1.0, 5.0)
    y = ref._ssd(x, dt, A, Bm, Cm, 8, ref._Rounder(None))
    torch.testing.assert_close(
        y, ssd_reference(x, dt, A, Bm, Cm, torch.zeros(4)), atol=1e-5,
        rtol=1e-5)


# ---------------------------------------------------------------------------
# K4 at head dim 224, K5 at the published chunk
# ---------------------------------------------------------------------------

def test_k4_plain_path_head_dim_224_against_dense():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 70, 224))
                                .astype(np.float32)) for _ in range(3))
    scale = 112 ** -0.5
    got = flash_attention(q, k, v, sm_scale=scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s.masked_fill(~torch.ones(70, 70, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        flash_attention_plain(q, k, v, sm_scale=scale, causal=True,
                              kv_len=70), want, atol=1e-5, rtol=1e-5)
    halves, smem = wgmma_geometry(224)
    assert halves == 4 and smem == 164_904


def test_k5_scan_at_chunk_256_runs_tiles_of_128():
    """``ssd_scan`` at the published chunk of 256 runs K5's tiles of 128
    and equals the sequential recurrence."""
    rng = np.random.default_rng(6)
    B, L, H, P, G, N = 1, 512, 4, 8, 2, 8

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) * scale

    x, Bm, Cm = t(B, L, H, P), t(B, L, G, N), t(B, L, G, N)
    dt = torch.nn.functional.softplus(t(B, L, H) - 3)
    A = -torch.exp(t(H, scale=0.5))
    D = t(H)
    y, h = ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, return_state=True)
    torch.testing.assert_close(y, ssd_reference(x, dt, A, Bm, Cm, D),
                               atol=2e-4, rtol=2e-4)
    y128 = ssd_scan(x, dt, A, Bm, Cm, D, chunk=128)
    assert torch.equal(y, y128)


def test_serve_lm_serves_the_smoke_config(capsys):
    gen = serve_lm.main(["--arch", "zamba2-7b", "--device", "cpu",
                         "--prompt-len", "16", "--tokens", "8"])
    assert gen.shape == (4, 8)
    assert "serve_lm OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# spans and their readers
# ---------------------------------------------------------------------------

def test_prefill_spans_and_counts():
    """While a profile is active, a prefill is one ``lm.prefill`` span
    (counts: tokens, batch, the K4 and K5 launches, none on the CPU) with
    one ``lm.mamba`` per layer and one ``lm.shared`` per site beneath it,
    each site naming its block; nothing is recorded with the gate off."""
    from repro_torch.runtime.telemetry import SPANS

    cfg = configs.get_smoke_config("zamba2-7b")
    model = LMModel(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    SPANS.clear()
    serve_lm.prefill(model, params, _tokens(2, 16), 20)
    assert SPANS.records() == []
    with torch.profiler.profile():
        serve_lm.prefill(model, params, _tokens(2, 16), 20)
    spans = SPANS.records()
    SPANS.clear()
    root = [s for s in spans if s.name == "lm.prefill"]
    assert len(root) == 1
    assert root[0].counts == {"tokens": 32, "batch": 2, "k4.launches": 0,
                              "k5.launches": 0}
    mamba = [s for s in spans if s.name == "lm.mamba"]
    shared = [s for s in spans if s.name == "lm.shared"]
    assert len(mamba) == 9 and len(shared) == 3
    assert all(s.parent == root[0].id for s in mamba + shared)
    assert [(s.counts["site"], s.counts["block"]) for s in shared] == [
        (0, 0), (1, 1), (2, 0)]


def _prefill_reader(name):
    import importlib.util

    path = REPO / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "prefill_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name,work,want_ms", [
    ("lm.mamba_ms.prefill", "mamba_flops", 7.0),
    ("lm.shared_ms.prefill", "shared_flops", 5.0)])
def test_prefill_span_readers(name, work, want_ms, monkeypatch):
    """Two traced prefills, 2 x 16 and 2 x 24 tokens: the first with
    mamba spans of 1 + 2 ms and a shared span of 2 ms, the second 4 ms
    and 3 ms; a mamba span with no traced prefill above it is not
    counted.  A reading is the summed spans over the layer's counted
    work in those prefills, in ms per TFLOP."""
    from types import SimpleNamespace

    from perfbench import counts_lm
    from repro_torch.runtime import telemetry

    ms = 1_000_000
    log = telemetry.SpanLog()
    with torch.profiler.profile():
        log.end(log.begin("lm.mamba", 0), 50 * ms)       # an orphan
        for t0, n, mamba, shared in ((100, 16, (1, 2), (2,)),
                                     (200, 24, (4,), (3,))):
            root = log.begin("lm.prefill", t0 * ms)
            t = t0
            for d in shared:
                log.end(log.begin("lm.shared", t * ms), (t + d) * ms)
                t += d
            for d in mamba:
                log.end(log.begin("lm.mamba", t * ms), (t + d) * ms)
                t += d
            log.end(root, t * ms, counts={"tokens": 2 * n, "batch": 2})
    m = ref.dims(tiny_config())
    fn = getattr(counts_lm, work)
    want = want_ms / ((fn(m, 2, 16) + fn(m, 2, 24)) * 1e-12)
    read = _prefill_reader(name)
    card = {"ctx": SimpleNamespace(device="cuda", layers=m)}
    monkeypatch.setattr(telemetry, "SPANS", log)
    assert read(card) == pytest.approx(want)
    assert read({"ctx": SimpleNamespace(device="cpu", layers=m)}) is None
    monkeypatch.setattr(telemetry, "SPANS", telemetry.SpanLog())
    assert read(card) is None
    monkeypatch.delattr(telemetry, "SPANS")       # a program without it
    assert read(card) is None
