"""The routed-expert block of repro_torch (``models/lm/moe.py``) against
the JAX reference on the CPU: sort-based ranks, the routing (top-k expert
ids, ranks within the expert, the capacity keep mask) bit-equal, the
block's output and the load-balance loss within tolerance.

The reference's routing is read where it happens: ``_ranks_by_sort`` is
wrapped for the call, and the jitted call returns, beside the block's
output, the expert id of every (token, slot) pair after fission and the
ranks the wrapped function gave.
Weights come from the reference's ``moe_meta`` at ``PRNGKey(0)`` carried
across by ``params_from_numpy``; inputs from numpy.  Tolerances: f32 at
1e-4 (the same f32 products summed in another order), bf16 at 2e-2 (a
few bf16 ulps of the rounded expert activations and output).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import moe as jmoe
from repro.models.lm import params as jparams
from repro_torch.models.lm import moe
from repro_torch.models.lm import params as params_lib

torch.set_num_threads(2)

D, F_FF, E = 32, 64, 8


@functools.lru_cache(maxsize=None)
def _params(dtype, fission=1):
    """(reference params, the port's copy); callers do not mutate them."""
    meta = jmoe.moe_meta(D, F_FF, E, dtype, fission=fission)
    jp = jax.jit(lambda k: jparams.materialize(meta, k))(
        jax.random.PRNGKey(0))
    return jp, params_lib.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _reference_moe(monkeypatch, jp, jx, table):
    """The reference's ``moe`` with its ``_ranks_by_sort`` recorded:
    (output, expert ids, ranks)."""
    seen = []
    inner = jmoe._ranks_by_sort

    def recorded(expert_of, n_experts):
        ranks = inner(expert_of, n_experts)
        seen.append((expert_of, ranks))
        return ranks

    def run(p, x):
        out = jmoe.moe(p, x, table=table)
        assert len(seen) == 1
        return (out,) + seen[0]

    monkeypatch.setattr(jmoe, "_ranks_by_sort", recorded)
    try:
        out, ids, ranks = jax.jit(run)(jp, jx)
    finally:
        monkeypatch.setattr(jmoe, "_ranks_by_sort", inner)
    return out, np.asarray(ids), np.asarray(ranks)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol)


def test_ranks_by_sort_reference_case():
    ids = [0, 1, 0, 2, 0, 1]
    got = moe._ranks_by_sort(torch.tensor(ids), 3)
    assert got.dtype == torch.int32
    assert got.tolist() == [0, 0, 1, 0, 2, 1]
    assert np.array_equal(got.numpy(), np.asarray(
        jmoe._ranks_by_sort(jnp.asarray(ids, jnp.int32), 3)))


@pytest.mark.parametrize("n,n_experts,seed", [
    (1, 1, 0), (64, 8, 1), (1000, 7, 2), (4096, 384, 3), (513, 2, 4)])
def test_ranks_by_sort_random_ids_bit_equal(n, n_experts, seed):
    ids = np.random.default_rng(seed).integers(0, n_experts, n)
    got = moe._ranks_by_sort(torch.from_numpy(ids), n_experts)
    want = np.asarray(jmoe._ranks_by_sort(jnp.asarray(ids, jnp.int32),
                                          n_experts))
    assert np.array_equal(got.numpy(), want)


def _check_moe(monkeypatch, dtype, tol, *, cf, fission=1, bfp=False,
               shape=(2, 32, D), top_k=2):
    table = {"n_experts": E, "top_k": top_k, "capacity_factor": cf,
             "fission": fission}
    if bfp:
        table.update(bfp=True, bfp_block=32, bfp_mantissa=10)
    jp, p = _params(dtype, fission)
    x = _x(shape)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(params_lib.as_dtype(dtype))
    want, want_ids, want_ranks = _reference_moe(monkeypatch, jp, jx, table)

    T = shape[0] * shape[1]
    k = top_k * fission
    cap = max(int(T * k * cf) // (E * fission), 4)
    r = moe.route(moe.router_gates(p, tx.reshape(T, shape[2])), table)
    assert (r.cap, r.n_experts, tuple(r.topi.shape)) == (cap, E * fission,
                                                         (T, k))
    assert np.array_equal(r.topi.reshape(-1).numpy(), want_ids)
    assert np.array_equal(r.pos.numpy(), want_ranks)
    assert np.array_equal(r.keep.numpy(), want_ranks < cap)

    got = moe.moe(p, tx, table=table)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, tol)
    return r


@pytest.mark.parametrize("cf", [0.25, 1.25, 16.0])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_moe_matches_reference(monkeypatch, dtype, tol, cf):
    r = _check_moe(monkeypatch, dtype, tol, cf=cf)
    dropped = int((~r.keep).sum())
    if cf == 0.25:
        assert dropped > 0
    if cf == 16.0:
        assert dropped == 0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_moe_fission_matches_reference(monkeypatch, dtype, tol):
    r = _check_moe(monkeypatch, dtype, tol, cf=1.25, fission=2)
    # the two slices of one expert carry adjacent virtual ids
    assert torch.equal(r.topi[:, 1::2] - r.topi[:, 0::2],
                       torch.ones_like(r.topi[:, 0::2]))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_moe_bfp_matches_reference(monkeypatch, dtype, tol):
    _check_moe(monkeypatch, dtype, tol, cf=1.25, bfp=True)


@pytest.mark.parametrize("shape", [(4, 1, D), (1, 1, D)])
def test_moe_decode_shape_matches_reference(monkeypatch, shape):
    """A decode step's few tokens: the capacity floor of 4 slots."""
    r = _check_moe(monkeypatch, "float32", 1e-4, cf=1.25, shape=shape)
    assert r.cap == 4 and bool(r.keep.all())


def test_moe_high_capacity_equals_dense_mixture():
    """Nothing drops at capacity factor 16: the block equals the per-expert
    dense mixture of the reference's test."""
    table = {"n_experts": E, "top_k": 2, "capacity_factor": 16.0}
    _, p = _params("float32")
    x = torch.from_numpy(_x((2, 32, D)))
    y = moe.moe(p, x, table=table)
    xt = x.reshape(-1, D)
    gates = torch.softmax(xt @ p["router"], dim=-1)
    topv, topi = torch.topk(gates, 2, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    dense = torch.zeros_like(xt)
    for e in range(E):
        h = torch.nn.functional.silu(xt @ p["wg"][e]) * (xt @ p["wu"][e])
        w = torch.where(topi == e, topv, 0.0).sum(-1)
        dense += (h @ p["wd"][e]) * w[:, None]
    torch.testing.assert_close(y.reshape(-1, D), dense, atol=2e-4,
                               rtol=2e-3)


def test_expert_matmul_widens_in_slices(monkeypatch):
    """bf16 experts on the CPU widen a few at a time; the product is the
    widened one."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((6, 3, 16))
                         .astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((6, 16, 8))
                         .astype(np.float32)).bfloat16()
    monkeypatch.setattr(moe, "WIDEN_BYTES", 2 * 16 * 8 * 4)
    got = moe._expert_matmul(a, w, torch.bfloat16)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), w.float()))


@pytest.mark.parametrize("skew", [False, True])
def test_aux_load_loss_matches_reference(skew):
    table = {"n_experts": E, "top_k": 2}
    jp, p = _params("float32")
    if skew:
        # most tokens to expert 0.  (The reference's test adds 100, where
        # the other experts' probabilities fall below 2^-126: XLA on the
        # CPU flushes them to zero and top_k breaks the ties by index,
        # torch keeps them, so the second choices differ.)
        jp = dict(jp, router=jp["router"].at[:, 0].add(4.0))
        p = dict(p, router=p["router"].clone())
        p["router"][:, 0] += 4.0
    x = _x((2, 32, D))
    got = moe.aux_load_loss(p, torch.from_numpy(x), table=table)
    want = jax.jit(functools.partial(jmoe.aux_load_loss, table=table))(
        jp, jnp.asarray(x))
    _close(got, want, 1e-5)
    if skew:
        balanced = moe.aux_load_loss(_params("float32")[1],
                                     torch.from_numpy(x), table=table)
        assert float(got) > float(balanced)
