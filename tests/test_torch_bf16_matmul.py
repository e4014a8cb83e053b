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


# The tools' five merged tensors (tools/profile_weight_stream.py), then a
# ragged K and a ragged N.
PLAN_SHAPES = [(3072, 4096), (3072, 2048), (4096, 3072), (3072, 18432), (9216, 3072),
               (1608, 3072), (3072, 1000)]


@pytest.mark.parametrize("k,n", PLAN_SHAPES)
@pytest.mark.parametrize("m", [1, 24, 64])
@pytest.mark.parametrize("per_sm", [2, 3])
def test_t3_plan_covers_k_in_one_wave(k, n, m, per_sm):
    """The plan's splits cover K, none is empty, each slice is whole
    stages, a column tile's splits fit one cluster (at most 8), and the
    grid (a block per column tile and split) fits one wave: `per_sm` blocks
    on each of 132 SMs, fewer for clusters that do not pack the card's
    8 GPCs of 16-18 SMs."""
    resident = [per_sm * 132 - (c - 1) * 8 for c in range(1, 9)]
    cols, stages, k_slice, splits = bm.t3_plan(m, k, n, resident)
    assert cols == 128 and stages >= 2
    assert k_slice % 64 == 0 and 1 <= splits <= 8
    assert k_slice * (splits - 1) < k <= k_slice * splits        # covered, none empty
    tiles = -(-n // cols)
    assert splits == 1 or tiles * splits <= resident[splits - 1]  # one wave of blocks


def test_kernel_entry_refuses_what_it_cannot_take():
    """The kernel takes 1 <= M <= 64, K and N multiples of 8, x and w
    16-byte aligned (whole 16-byte chunks of every row); the wrapper
    refuses the rest before it looks for the card."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        bm.bf16_matmul_kernel(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        bm.bf16_matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="multiples of 8"):
        bm.bf16_matmul_kernel(x, torch.zeros((64, 12), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiples of 8"):
        bm.bf16_matmul_kernel(torch.zeros((4, 12), dtype=torch.bfloat16),
                              torch.zeros((12, 128), dtype=torch.bfloat16))
    shifted = torch.zeros(64 * 128 + 4, dtype=torch.bfloat16)[4:].view(64, 128)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        bm.bf16_matmul_kernel(x, shifted)
    with pytest.raises(ValueError, match="1..64"):
        bm.bf16_matmul_kernel(torch.zeros((65, 64), dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="1..64"):
        bm.t3_plan(65, 64, 128, [264] * 8)
