"""The CUDA kernels of repro_torch against their plain torch versions on
the same card tensors (marked ``cuda``; they skip without a GPU).  This
file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import winograd as wg
from repro_torch.kernels.bfp_matmul import (
    bfp_matmul_quantized, bfp_matmul_quantized_plain, quantize_operands)
from repro_torch.kernels.cc_label import cc_label_tiled, local_spread_converge
from repro_torch.kernels.winograd_conv import (
    winograd_conv2d, winograd_tiles, winograd_tiles_plain)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _maps(seed, n, h, w, p_link=0.5):
    rng = np.random.default_rng(seed)
    score = rng.uniform(0.0, 1.0, (n, h, w)).astype(np.float32)
    links = (rng.uniform(0.0, 1.0, (n, h, w, 8)) < p_link).astype(np.float32)
    return score, links


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """CUDA kernel against its plain version on the same card tensors."""

    def test_winograd_kernel(self):
        dev = _cuda()
        x = torch.from_numpy(_normal(0, (2, 37, 29, 19))).to(dev)
        w = torch.from_numpy(_normal(1, (3, 3, 19, 45))).to(dev)
        b = torch.from_numpy(_normal(2, (45,))).to(dev)
        got = winograd_conv2d(x, w, b, relu=True)
        v, (oh, ow, th, tw) = wg.input_tiles(x)
        u = wg.transform_weights(w).reshape(36, 19, 45)
        want = winograd_tiles_plain(v, u, b, relu=True, n=2, th=th, tw=tw,
                                    out_h=oh, out_w=ow)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
        assert winograd_tiles.launches >= 1

    def test_bfp_matmul_kernel(self):
        dev = _cuda()
        ops = quantize_operands(torch.from_numpy(_normal(0, (130, 528))).to(dev),
                                torch.from_numpy(_normal(1, (528, 70))).to(dev))
        got = bfp_matmul_quantized(*ops)
        want = bfp_matmul_quantized_plain(*ops, block_size=32,
                                          mantissa_bits=10)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    def test_cc_kernel(self):
        dev = _cuda()
        score, links = _maps(3, 2, 64, 96, 0.7)
        s, l = torch.from_numpy(score).to(dev), torch.from_numpy(links).to(dev)
        got = cc_label_tiled(s, l, return_stats=True)
        want = cc_label_tiled(s.cpu(), l.cpu(), return_stats=True)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert local_spread_converge.launches >= 1

    def test_wrappers_count_one_launch_and_check_inputs(self):
        dev = _cuda()
        from repro_torch import kernels

        v = torch.zeros((4, 36, 3), device=dev)
        u = torch.zeros((36, 3, 5), device=dev)
        geo = dict(n=1, th=2, tw=2, out_h=8, out_w=8)
        kernels.reset_launch_counts()
        winograd_tiles(v, u, **geo)
        assert kernels.launch_counts()["winograd_tiles"] == 1
        with pytest.raises(ValueError):
            winograd_tiles(v.double(), u.double(), **geo)
        with pytest.raises(ValueError):
            winograd_tiles(v.transpose(0, 1).contiguous().transpose(0, 1),
                           u, **geo)
        assert kernels.launch_counts()["winograd_tiles"] == 1
