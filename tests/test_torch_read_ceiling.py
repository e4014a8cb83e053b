"""The read ceilings (voxtral_tpu_torch.ops.read_ceiling) against the Pallas
kernels they port, run in interpret mode on the CPU:

- T1 `wread` (tools/profile_q8_matmul_roofline.py) and T11 `rd`
  (tools/profile_dma_ceiling.py): those tools run their benchmarks at
  import, so only `read_kernel` and `wread` / `rd` are taken from their
  source (ast) and executed in a namespace with small shapes. Both exact.
- T2 `pure_stream` (tools/profile_weight_stream.py, imported, its blocks
  set small): within 1e-6 of max|out| (the same order of adds: exact).
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl
from jax.experimental.pallas import tpu as pltpu

from tools import profile_weight_stream as pws
from voxtral_tpu_torch.ops import read_ceiling as rc
from voxtral_tpu_torch.tools._timing import copies_beyond_l2
from voxtral_tpu_torch.tools.profile_dma_ceiling import rd_chain

torch.set_num_threads(2)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
B, P, KV_DIM = 2, 16, 1024


@pytest.fixture
def interpret(monkeypatch):
    """The tools' kernels call `pl.pallas_call`; run them in interpret mode."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


def _tool_functions(filename, names):
    """The named top-level functions of a tool's source, executed alone in a
    namespace holding jax, jnp, pl, pltpu and the small B, P, KV_DIM."""
    path = os.path.join(TOOLS, filename)
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = dict(jax=jax, jnp=jnp, pl=jpl, pltpu=pltpu, B=B, P=P, KV_DIM=KV_DIM)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def _codes(rng, shape):
    return rng.randint(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("k,n", [(64, 1024), (37, 512)])
def test_wread_plain_matches_pallas_kernel(interpret, k, n):
    wread = _tool_functions("profile_q8_matmul_roofline.py", ["read_kernel", "wread"])["wread"]
    q = _codes(np.random.RandomState(k), (k, n))
    want = np.asarray(wread(jnp.asarray(q)))
    got = rc.wread(torch.from_numpy(q))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rc.wread_plain(torch.from_numpy(q)).numpy(), want)
    assert rc.LAUNCHES["wread"] == 0                  # the CPU never launches T1


@pytest.mark.parametrize("blk", [512, 1024])
@pytest.mark.parametrize("salt", [0.375, 1.0e-3, -7.25e-5])
def test_rd_plain_matches_pallas_kernel(interpret, blk, salt):
    """Bit for bit: the sums are exact, the salt's add rounds once, in the
    JAX order (ksum + vsum) + salt."""
    rd = _tool_functions("profile_dma_ceiling.py", ["read_kernel", "rd"])["rd"]
    rng = np.random.RandomState(blk)
    k, v = _codes(rng, (B, P, KV_DIM)), _codes(rng, (B, P, KV_DIM))
    s = np.full((1, 1), salt, np.float32)
    want = np.asarray(rd(jnp.asarray(k), jnp.asarray(v), jnp.asarray(s), blk=blk))
    got = rc.rd(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, KV_DIM)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rc.LAUNCHES["rd"] == 0


def _bf16(rng, shape):
    """numpy f32 values that bf16 holds exactly, and the same as torch bf16."""
    x = jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.05).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("k,n", [(128, 256), (48, 384), (192, 128)])
def test_pure_stream_plain_matches_pallas_kernel(interpret, monkeypatch, k, n):
    """Grid (N / 128, K / 64) blocks of the bf16 weight, K-inner; a K
    smaller than the block is one block of K rows."""
    monkeypatch.setattr(pws, "BLK_K", 64)
    monkeypatch.setattr(pws, "BLK_N", 128)
    wj, wt = _bf16(np.random.RandomState(k + n), (k, n))
    want = np.asarray(pws.pure_stream(wj))
    got = rc.pure_stream(wt, 64, 128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    tol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert rc.LAUNCHES["pure_stream"] == 0


def test_pure_stream_ragged_blocks_add_their_tiles():
    """Where K or N is not a multiple of its block, the last blocks' tiles
    (clipped to the matrix) are added too."""
    w = torch.arange(20 * 300, dtype=torch.float32).reshape(20, 300).to(torch.bfloat16)
    got = rc.pure_stream_plain(w, 16, 256)
    wf = w.float()
    want = torch.zeros(8, 128)
    for c0 in (0, 256):
        for r0 in (0, 16):
            tile = wf[r0:r0 + 8, c0:c0 + 128]
            want[:tile.shape[0], :tile.shape[1]] += tile
    assert torch.equal(got, want)
    assert got[4:, 44:].abs().sum() > 0 and torch.equal(got[4:, 44:], wf[4:8, 44:128])


def test_word_checksum_is_the_wrapping_sum_of_words():
    rng = np.random.RandomState(5)
    w = rng.randint(-2**15, 2**15, size=(64, 40)).astype(np.int16)
    want = int(w.view(np.uint32).astype(np.uint64).sum() % 2**32)
    assert rc.word_checksum_plain(torch.from_numpy(w).view(torch.bfloat16)) == want


@pytest.mark.parametrize("batch,rows,cols", [(1, 3072, 4096), (1, 9216, 3072),
                                             (16, 2088, 1024), (3, 77, 528), (1, 1, 16)])
def test_column_split_covers_rows(batch, rows, cols):
    k_slice, splits = rc.col_split(batch, rows, cols, 132)
    assert k_slice % 64 == 0 and 1 <= splits <= 65535
    assert k_slice * (splits - 1) < rows <= k_slice * splits


def test_rd_chain_carries_each_output_as_the_next_salt():
    rng = np.random.RandomState(9)
    pairs = [(torch.from_numpy(_codes(rng, (2, 8, 32))), torch.from_numpy(_codes(rng, (2, 8, 32))))
             for _ in range(2)]
    salt0 = torch.tensor([0.5])
    out = rd_chain(pairs, 3, salt0)
    want = salt0
    for i in range(3):
        want = rc.rd_plain(*pairs[i % 2], want.reshape(-1)[0])
    assert torch.equal(out, want)
    assert copies_beyond_l2(68_419_584, 50 * 2**20, 26) == 4
    assert copies_beyond_l2(100, 50 * 2**20, 26) == 26
    assert copies_beyond_l2(10**9, 50 * 2**20, 8) == 1


def test_cuda_only_entry_points_refuse_cpu_tensors():
    q = torch.zeros((64, 512), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        rc.wread_kernel(q)
    with pytest.raises(ValueError, match="CUDA"):
        rc.rd_kernel(q[None], q[None], torch.zeros(1))
    with pytest.raises(ValueError, match="CUDA"):
        rc.pure_stream_kernel(q.view(torch.bfloat16))
    with pytest.raises(ValueError, match="unsupported device"):
        rc.wread(q.to("meta"))
