"""The fused tied-logits + greedy argmax (voxtral_tpu_torch.ops.logits_argmax)
against the TPU kernel it ports, tools/profile_logits.py::fused_logits_argmax,
run in Pallas interpret mode on the CPU, and against the JAX package's
embed_logits + jnp.argmax: same tokens (ties to the first index), same f32
logits within rtol 1e-5 (summation order)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from tools import profile_logits
from voxtral_tpu.ops.linear import embed_logits as jax_embed_logits
from voxtral_tpu.quant import Quantized as JaxQuantized
from voxtral_tpu_torch.ops import logits_argmax as la
from voxtral_tpu_torch.quant import Quantized

torch.set_num_threads(2)

B, V, D, BLK = 3, 1024, 64, 256


@pytest.fixture
def interpret(monkeypatch):
    """The tool's kernel calls `pl.pallas_call`; run it in interpret mode."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


def _case(table, seed, tie):
    """h [B, D] (bf16 values) and a table: "int8" (codes + per-row f32
    scales), "bf16" or "f32". With `tie`, rows 700 and 900 repeat row 300
    (and its scale), made to be every stream's largest logit: the first
    index, 300, must win across blocks of BLK rows; rows 301 and 310 repeat
    it too for a tie inside one block."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, D).astype(np.float32)
    h = np.array(jnp.asarray(h).astype(jnp.bfloat16).astype(jnp.float32))
    s = None
    if table == "int8":
        t = rng.randint(-127, 128, size=(V, D)).astype(np.int8)
        s = (rng.rand(V) * 0.02 + 0.001).astype(np.float32)
    else:
        t = (rng.randn(V, D) * 0.05).astype(np.float32)
        if table == "bf16":
            t = np.array(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))
    if tie:
        big = np.sign(h.sum(0))                 # aligned with every stream's h
        t[300] = (127 * big).astype(t.dtype) if table == "int8" else big
        for r in (301, 310, 700, 900):
            t[r] = t[300]
        if s is not None:
            s[300] = 0.5
            s[[301, 310, 700, 900]] = s[300]
    return h, t, s


def _jax_table(table, t, s):
    if table == "int8":
        return jnp.asarray(t), jnp.asarray(s).reshape(1, V)
    return jnp.asarray(t).astype(jnp.bfloat16 if table == "bf16" else jnp.float32), None


def _torch_table(table, t, s):
    if table == "int8":
        return torch.from_numpy(t), torch.from_numpy(s)
    tt = torch.from_numpy(t)
    return (tt.to(torch.bfloat16) if table == "bf16" else tt), None


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("table", ["int8", "bf16", "f32"])
def test_plain_matches_pallas_kernel(interpret, table, tie):
    h, t, s = _case(table, 1 if tie else 0, tie)
    jt, js = _jax_table(table, t, s)
    want = profile_logits.fused_logits_argmax(jnp.asarray(h).astype(jnp.bfloat16), jt, js, BLK)
    tt, ts = _torch_table(table, t, s)
    got = la.logits_argmax_plain(torch.from_numpy(h).to(torch.bfloat16), tt, ts)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if tie:
        assert (got.numpy() == 300).all()


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table", ["int8", "bf16", "f32"])
def test_wrappers_match_jax_embed_logits(table, h_dtype):
    """`logits_argmax` / `tied_logits` on a float or Q8 table (on the CPU:
    the plain version) against JAX's embed_logits (h cast to a float
    table's dtype, kept for a Q8 one) and jnp.argmax."""
    h, t, s = _case(table, 2, False)
    h = (h + np.random.RandomState(3).randn(B, D).astype(np.float32) * 1e-3)
    jdt = jnp.float32 if h_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if h_dtype == "float32" else torch.bfloat16
    jt, js = _jax_table(table, t, s)
    jemb = JaxQuantized(q=jt, s=js.reshape(V), axis=0) if table == "int8" else jt
    tt, ts = _torch_table(table, t, s)
    temb = Quantized(tt, ts, axis=0) if table == "int8" else tt
    hj, ht = jnp.asarray(h).astype(jdt), torch.from_numpy(h).to(tdt)
    lj = np.asarray(jax_embed_logits(hj, jemb))
    lt = la.tied_logits(ht[None], temb)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (1, B, V)
    np.testing.assert_allclose(lt[0].numpy(), lj, rtol=1e-5, atol=1e-5)
    tok = la.logits_argmax(ht, temb)
    np.testing.assert_array_equal(tok.numpy(), np.argmax(lj, axis=-1))
    assert la.LAUNCHES["fused_logits_argmax"] == 0    # the CPU never launches K3


def test_first_index_wins_on_exact_ties():
    table = torch.zeros((8, 16), dtype=torch.bfloat16)
    table[2] = table[5] = 1.0
    h = torch.ones((2, 16))
    np.testing.assert_array_equal(la.logits_argmax(h, table).numpy(), [2, 2])
    q = Quantized(torch.ones((8, 16), dtype=torch.int8), torch.ones(8), axis=0)
    np.testing.assert_array_equal(la.logits_argmax(h, q).numpy(), [0, 0])
    with pytest.raises(ValueError, match="axis=0"):
        la.logits_argmax(h, Quantized(q.q, q.s, axis=-1))
