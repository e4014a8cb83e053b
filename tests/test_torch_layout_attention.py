"""The int4-unpack and ring-layout attention kernels' plain versions
(voxtral_tpu_torch.ops.layout_attention, as the port's routes run them on
the CPU) against the Pallas kernels they port, run in interpret mode:

- T4 `attn8` and T5 `attn4` (tools/profile_int4_unpack.py), T5 under both
  of the tool's unpack variants;
- T6 `attn3d` and T7 `attn4d` (tools/profile_attn_layout.py), with slots
  the mask cuts and a stream whose slots are all masked.

Both tools benchmark at import, so only their kernel functions are taken
from the source (ast) and executed in a namespace with small B and P.
Tolerance: two bf16 ulps of max|out| (T5_CHECK_RTOL): the probabilities
round to bf16 after f32 dots summed in another order, and the output
rounds to bf16 again.
"""

import ast
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl
from jax.experimental.pallas import tpu as pltpu

from voxtral_tpu_torch.ops import layout_attention as la
from voxtral_tpu_torch.quant import pack_int4, unpack_int4
from voxtral_tpu_torch.tools.profile_int4_unpack import CHECK_STREAMS, T5_CHECK_RTOL, int4_check

torch.set_num_threads(2)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
B, P, KV_DIM, HKV = 2, 24, 1024, 8
UNPACK_FNS = ["unpack", "kern8", "attn8", "kern4", "attn4"]
LAYOUT_FNS = ["_cell", "attn3d", "attn4d"]


@pytest.fixture
def interpret(monkeypatch):
    """The tools' kernels call `pl.pallas_call`; run them in interpret mode."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


def _tool_functions(filename, names, **consts):
    """The named top-level functions of a tool's source, executed alone in a
    namespace holding jax, jnp, pl, pltpu, math and `consts`."""
    path = os.path.join(TOOLS, filename)
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = dict(jax=jax, jnp=jnp, pl=jpl, pltpu=pltpu, math=math, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def _unpack_tool(b=B, unpack="i32"):
    return _tool_functions("profile_int4_unpack.py", UNPACK_FNS, B=b, P=P, HD=128, GROUP=4,
                           BLK=512, UNPACK=unpack)


def _layout_tool(b=B):
    return _tool_functions("profile_attn_layout.py", LAYOUT_FNS, B=b, P=P, HKV=HKV, HD=128,
                           GROUP=4, HEADS=4 * HKV, KV_DIM=KV_DIM, _NEG=-1e30)


def _q(values):
    """numpy f32 -> (jax bf16, torch bf16) with the same values."""
    qj = jnp.asarray(values, jnp.bfloat16)
    return qj, torch.from_numpy(np.array(qj.astype(jnp.float32))).to(torch.bfloat16)


def _close(got, want):
    """got (torch) within T5_CHECK_RTOL x max|want| of want (numpy)."""
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=T5_CHECK_RTOL * np.abs(want).max())


def _codes(rng, shape, lo=-127, hi=127):
    return rng.randint(lo, hi, size=shape).astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1])
def test_attn8_plain_matches_pallas_kernel(interpret, seed):
    rng = np.random.RandomState(seed)
    qj, qt = _q(rng.randn(B, 1, 4 * KV_DIM) * 0.05)
    kr, vr = _codes(rng, (B, P, KV_DIM)), _codes(rng, (B, P, KV_DIM))
    want = np.asarray(_unpack_tool()["attn8"](qj, jnp.asarray(kr), jnp.asarray(vr))
                      .astype(jnp.float32))
    got = la.attn8(qt, torch.from_numpy(kr), torch.from_numpy(vr))
    assert got.dtype == torch.bfloat16
    _close(got, want)
    assert np.abs(want).max() > 127                  # unnormalised, as in the tool
    assert la.LAUNCHES["attn8"] == 0                  # the CPU never launches T4


@pytest.mark.parametrize("unpack", ["i32", "f32"])
def test_attn4_plain_matches_pallas_kernel(interpret, unpack):
    """Packed bytes over the whole int8 range: both of the tool's unpack
    variants give the same nibbles, and the port follows them."""
    rng = np.random.RandomState(3)
    qj, qt = _q(rng.randn(B, 1, 4 * KV_DIM) * 0.05)
    krp = _codes(rng, (B, P, KV_DIM // 2), -128, 128)
    vrp = _codes(rng, (B, P, KV_DIM // 2), -128, 128)
    want = np.asarray(_unpack_tool(unpack=unpack)["attn4"](qj, jnp.asarray(krp),
                                                           jnp.asarray(vrp))
                      .astype(jnp.float32))
    got = la.attn4(qt, torch.from_numpy(krp), torch.from_numpy(vrp))
    assert got.dtype == torch.bfloat16
    _close(got, want)
    assert la.LAUNCHES["attn4"] == 0


def _positions(masked):
    """(sp [B, 1, P], qp [B, 1, 1]): the tool's (every slot valid), or
    masked: sp = 400 j with slot 3 negative and slot 7 past qp; qp = 9000
    cuts the slots below 9000 - 8191 (the window); stream 1's qp is
    negative, so every one of its slots is masked."""
    sp = np.tile(np.arange(P, dtype=np.int32), (B, 1)).reshape(B, 1, P)
    qp = np.full((B, 1, 1), P + 10, np.int32)
    if masked:
        sp = sp * 400
        sp[0, 0, 3], sp[0, 0, 7] = -5, 10**6
        qp[:] = 9000
        qp[1] = -3
    return sp, qp


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("blk", [256, 512, 1024])
def test_attn3d_attn4d_plain_match_pallas_kernels(interpret, blk, masked):
    """T6 and T7 against the Pallas kernels on the same values in both
    layouts; T6 == T7 exactly; a fully masked stream gives exact zeros."""
    nb, sub = KV_DIM // blk, blk // 128
    rng = np.random.RandomState(blk + masked)
    qj, qt = _q(rng.rand(B, 1, 4 * KV_DIM) - 0.5)
    kr, vr = _codes(rng, (B, P, KV_DIM)), _codes(rng, (B, P, KV_DIM))
    sp, qp = _positions(masked)
    ks = rng.uniform(0.005, 0.02, (B, nb, sub, P)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, nb, sub, P)).astype(np.float32)
    kr4, vr4 = (r.reshape(B, P, nb, blk).transpose(0, 2, 1, 3).copy() for r in (kr, vr))
    tool = _layout_tool()
    rest = [jnp.asarray(x) for x in (sp, qp, ks, vs)]
    want3 = np.asarray(tool["attn3d"](qj, jnp.asarray(kr), jnp.asarray(vr), *rest, blk=blk)
                       .astype(jnp.float32))
    want4 = np.asarray(tool["attn4d"](qj, jnp.asarray(kr4), jnp.asarray(vr4), *rest, blk=blk)
                       .astype(jnp.float32))
    t = [torch.from_numpy(x) for x in (sp, qp, ks, vs)]
    assert torch.equal(la.to_block_major(torch.from_numpy(kr), blk), torch.from_numpy(kr4))
    got3 = la.attn3d(qt, torch.from_numpy(kr), torch.from_numpy(vr), *t, blk)
    got4 = la.attn4d(qt, torch.from_numpy(kr4), torch.from_numpy(vr4), *t, blk)
    assert got3.dtype == got4.dtype == torch.bfloat16
    _close(got3, want3)
    _close(got4, want4)
    assert torch.equal(got3, got4)
    if masked:
        assert np.all(want3[1] == 0) and torch.count_nonzero(got3[1]) == 0
        assert np.abs(want3[0]).max() > 0
    assert la.LAUNCHES["attn3d"] == la.LAUNCHES["attn4d"] == 0


def test_masked_slots_do_not_count():
    """Changing the K codes of a masked slot (each of the mask's
    three cuts) leaves T6's output as it was; a valid slot's change moves
    it."""
    rng = np.random.RandomState(11)
    sp, qp = _positions(True)
    _, qt = _q(rng.rand(B, 1, 4 * KV_DIM) - 0.5)
    kr = torch.from_numpy(_codes(rng, (B, P, KV_DIM)))
    vr = torch.from_numpy(_codes(rng, (B, P, KV_DIM)))
    ks = torch.full((B, 4, 2, P), 0.01)
    args = [torch.from_numpy(sp), torch.from_numpy(qp), ks, ks, 256]
    base = la.attn3d(qt, kr, vr, *args)
    assert sp[0, 0, 2] < 9000 - 8191 <= sp[0, 0, 4]
    # slot 3: sp < 0; slot 7: sp > qp; slot 2: before the window; slot 4 valid
    for slot, changes in ((3, False), (7, False), (2, False), (4, True)):
        k2 = kr.clone()
        k2[0, slot] = -k2[0, slot]
        assert torch.equal(la.attn3d(qt, k2, vr, *args)[0], base[0]) != changes, slot


def test_reference_kernels_read_the_batch_from_a_global(interpret):
    """The tools' kernels take the grid's batch from the module global B at
    trace time: with B = 1 and two streams, attn8 leaves stream 1 unwritten
    and attn3d returns one stream. The port takes the batch from the
    tensors and equals the reference traced at the right B."""
    rng = np.random.RandomState(5)
    qj, qt = _q(rng.randn(B, 1, 4 * KV_DIM) * 0.05)
    kr, vr = _codes(rng, (B, P, KV_DIM)), _codes(rng, (B, P, KV_DIM))
    one = np.asarray(_unpack_tool(b=1)["attn8"](qj, jnp.asarray(kr), jnp.asarray(vr))
                     .astype(jnp.float32))
    right = np.asarray(_unpack_tool(b=2)["attn8"](qj, jnp.asarray(kr), jnp.asarray(vr))
                       .astype(jnp.float32))
    np.testing.assert_array_equal(one[0], right[0])
    assert not np.array_equal(one[1], right[1])
    _close(la.attn8(qt, torch.from_numpy(kr), torch.from_numpy(vr)), right)
    sp, qp = _positions(False)
    ks = np.full((B, 4, 2, P), 0.01, np.float32)
    out = _layout_tool(b=1)["attn3d"](qj, *[jnp.asarray(x) for x in (kr, vr, sp, qp, ks, ks)],
                                      blk=256)
    assert out.shape == (1, 1, 4 * KV_DIM)
    got = la.attn3d(qt, *[torch.from_numpy(x) for x in (kr, vr, sp, qp, ks, ks)], 256)
    assert got.shape == (B, 1, 4 * KV_DIM)


@pytest.mark.parametrize("slots", [24, 333])
def test_tool_check_holds_on_the_port(slots):
    """The int4-unpack tool's own check: T5 on packed rings against T4 on
    the same int4-range values, within T5_CHECK_RTOL of max|T4|; and the
    tool's packing is `quant.unpack_int4`'s layout."""
    g = torch.Generator().manual_seed(slots)
    err, omax = int4_check(CHECK_STREAMS, slots, KV_DIM, g, "cpu")
    assert omax > 0 and err <= T5_CHECK_RTOL * omax
    codes = torch.randint(-8, 8, (2, 3, 256), generator=g, dtype=torch.int8)
    lo, hi = unpack_int4(pack_int4(codes.view(2, 3, 2, 128)))
    assert torch.equal(torch.cat([lo, hi], -1).reshape(2, 3, 256), codes.to(torch.int32))
    assert la.LAUNCHES == dict.fromkeys(la.LAUNCHES, 0)


def test_chain_feeds_each_output_back():
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(B, 1, 512).astype(np.float32) * 0.05).to(torch.bfloat16)
    rings = [torch.from_numpy(_codes(rng, (B, 8, 128))) for _ in range(3)]
    out = la.chain(la.attn8, q, rings[:2], rings[1:], 3)
    want = q
    for i in range(3):
        want = want + 0.001 * la.attn8(want, rings[i % 2], rings[1 + i % 2])
    assert torch.equal(out, want) and out.dtype == torch.bfloat16


def _unmasked_args(packed=False, b=2, p=16, kv=256):
    lanes = kv // 2 if packed else kv
    return (torch.zeros((b, 1, 4 * kv), dtype=torch.bfloat16),
            torch.zeros((b, p, lanes), dtype=torch.int8),
            torch.zeros((b, p, lanes), dtype=torch.int8))


def _masked_args(b=2, p=16, blk=256, block_major=False):
    kv = 1024
    ring = (b, kv // blk, p, blk) if block_major else (b, p, kv)
    return (torch.zeros((b, 1, 4 * kv), dtype=torch.bfloat16),
            torch.zeros(ring, dtype=torch.int8), torch.zeros(ring, dtype=torch.int8),
            torch.zeros((b, 1, p), dtype=torch.int32), torch.zeros((b, 1, 1), dtype=torch.int32),
            torch.zeros((b, kv // blk, blk // 128, p)), torch.zeros((b, kv // blk, blk // 128, p)),
            blk)


@pytest.mark.parametrize("name,call", [
    ("attn8", lambda: la.attn8_kernel(*_unmasked_args())),
    ("attn4", lambda: la.attn4_kernel(*_unmasked_args(True))),
    ("attn3d", lambda: la.attn3d_kernel(*_masked_args())),
    ("attn4d", lambda: la.attn4d_kernel(*_masked_args(block_major=True))),
])
def test_cuda_entry_points_refuse_cpu_tensors(name, call):
    with pytest.raises(ValueError, match=f"{name} needs CUDA tensors"):
        call()


def _swap(args, i, new):
    return tuple(new if j == i else a for j, a in enumerate(args))


@pytest.mark.parametrize("case,match", [
    (lambda: la.attn8_kernel(*_swap(_unmasked_args(), 0, torch.zeros(2, 1, 1024))),
     "takes torch.bfloat16"),
    (lambda: la.attn8_kernel(*_swap(_unmasked_args(), 1, torch.zeros(2, 16, 256,
                                                                    dtype=torch.uint8))),
     "takes torch.int8"),
    (lambda: la.attn4_kernel(*_swap(_unmasked_args(True), 2, torch.zeros(2, 16, 128,
                                                                         dtype=torch.int32))),
     "takes torch.int8"),
    (lambda: la.attn3d_kernel(*_swap(_masked_args(), 3, torch.zeros(2, 1, 16))),
     "takes torch.int32"),
    (lambda: la.attn4d_kernel(*_swap(_masked_args(block_major=True), 5,
                                     torch.zeros(2, 4, 2, 16, dtype=torch.float64))),
     "takes torch.float32"),
    # hd other than 128: 96-lane heads
    (lambda: la.attn8_kernel(*_unmasked_args(kv=96)), "rings"),
    (lambda: la.attn4_kernel(*_unmasked_args(True, kv=96)), "rings"),
    # q lanes not 4 x kv_dim
    (lambda: la.attn8_kernel(*_swap(_unmasked_args(), 0, torch.zeros(
        (2, 1, 512), dtype=torch.bfloat16))), "does not match"),
    # score rows beyond the block's shared memory
    (lambda: la.attn8_kernel(*_unmasked_args(p=20000)), "shared memory"),
    (lambda: la.attn3d_kernel(*_masked_args(p=14000)), "shared memory"),
    # blk that does not tile the kv lanes, scales of another blk
    (lambda: la.attn3d_kernel(*_masked_args(blk=384)), "blk 384"),
    (lambda: la.attn3d_kernel(*_masked_args()[:-1], 512), "do not match"),
    (lambda: la.attn4d_kernel(*_masked_args(block_major=True)[:-1], 512), "blk 512"),
])
def test_cuda_entry_points_refuse_what_they_do_not_take(case, match):
    with pytest.raises(ValueError, match=match):
        case()


def test_routes_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        la.attn8(*(t.to("meta") for t in _unmasked_args()))
