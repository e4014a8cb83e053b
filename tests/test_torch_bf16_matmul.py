"""The skinny bf16 product (voxtral_tpu_torch.ops.bf16_matmul, T3) against
the Pallas kernel it ports, tools/profile_weight_stream.py::pallas_matmul,
run in interpret mode on the CPU with small blocks: within 1e-4 of
max|out| (exact bf16 products, another summation order) where K is a
multiple of the block. Where it is not, the Pallas grid (k // bk steps)
leaves out the last K % bk rows; the port computes the whole product."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from tools import profile_weight_stream as pws
from voxtral_tpu_torch.ops import bf16_matmul as bm

torch.set_num_threads(2)

BK, BN = 64, 128


@pytest.fixture
def small_blocks(monkeypatch):
    """Interpret mode and [64, 128] blocks for the tool's kernel."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    monkeypatch.setattr(pws, "BLK_K", BK)
    monkeypatch.setattr(pws, "BLK_N", BN)


def _bf16(rng, shape, scale):
    """(jax bf16 array, torch bf16 tensor) of the same values."""
    x = jnp.asarray(rng.randn(*shape).astype(np.float32) * scale).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(4, 128, 256), (1, 64, 128), (9, 192, 384)])
def test_plain_matches_pallas_kernel(small_blocks, m, k, n):
    rng = np.random.RandomState(m * k + n)
    xj, xt = _bf16(rng, (m, k), 1.0)
    wj, wt = _bf16(rng, (k, n), 0.05)
    want = np.asarray(pws.pallas_matmul(xj, wj))
    got = bm.bf16_matmul(xt, wt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(bm.bf16_matmul_plain(xt, wt).numpy(), want, rtol=0, atol=tol)
    assert bm.LAUNCHES["bf16_matmul"] == 0           # the CPU never launches T3


def test_reference_tool_drops_the_k_tail(small_blocks):
    """At K = BK + 32 the tool's grid has one K step: its result is the
    product over the first BK rows only. The port's is over all K rows."""
    rng = np.random.RandomState(11)
    k = BK + 32
    xj, xt = _bf16(rng, (4, k), 1.0)
    wj, wt = _bf16(rng, (k, BN), 0.05)
    want_head = np.asarray(xt[:, :BK].float() @ wt[:BK].float())
    want_whole = np.asarray(xt.float() @ wt.float())
    tool = np.asarray(pws.pallas_matmul(xj, wj))
    tol = 1e-4 * np.abs(want_whole).max()
    np.testing.assert_allclose(tool, want_head, rtol=0, atol=tol)
    assert np.abs(tool - want_whole).max() > 100 * tol      # the tail is missing
    np.testing.assert_allclose(bm.bf16_matmul(xt, wt).numpy(), want_whole, rtol=0, atol=tol)


@pytest.mark.parametrize("k,n", [(3072, 4096), (3072, 2048), (4096, 3072), (3072, 18432),
                                 (9216, 3072), (1608, 1000), (8, 4)])
@pytest.mark.parametrize("slots", [4 * 132, 6 * 132])
def test_split_k_covers_k_in_one_wave(k, n, slots):
    k_slice, splits = bm.split_k(k, n, slots)
    assert k_slice % 16 == 0 and k_slice >= 16 and 1 <= splits <= 65535
    assert k_slice * (splits - 1) < k <= k_slice * splits
    tiles = -(-n // 32)
    assert splits == 1 or tiles * splits <= slots          # one wave of blocks


def test_kernel_entry_refuses_what_it_cannot_take():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        bm.bf16_matmul_kernel(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        bm.bf16_matmul(x.to("meta"), w.to("meta"))
