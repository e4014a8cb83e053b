"""T5's tensor-core route (`attn4_mma_kernel` in csrc/layout_attention.cu,
the port of tools/profile_int4_unpack.py:131 `attn4`) checked on the CPU,
where the kernel cannot run (chip_smoke.py holds it against the plain
version on the card):

- its rounding points, emulated in plain torch (a fixed split of P into
  shares of 16-slot tiles, the global max over the splits, e rounded to
  bf16 once against it, per-split f32 partials added in split order, the
  output rounded to bf16), against the tool's Pallas kernel in interpret
  mode under both of its unpack variants and at ragged P, within
  T5_CHECK_RTOL of max|ref| (one 128-deep product against the tool's two
  64-deep ones);
- its fragment mapping, lane by lane in numpy: the cp.async copies into
  a stage of two swizzled tiles, the nibble-to-bf16 pairs, the A and B registers of
  both products, mma.sync m16n8k16, the epilogue's output lanes, and that
  every shared-memory access of a warp meets no bank conflict;
- `ops/layout_attention.t5_plan` (the split and its refusals) and the
  entry's refusals before the card;
- the variant sources of `tools/profile_t5_variants.py`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layout_attention import _tool_functions, interpret  # noqa: F401

from voxtral_tpu_torch.ops import layout_attention as la
from voxtral_tpu_torch.tools import profile_t5_variants as t5v
from voxtral_tpu_torch.quant import pack_int4, unpack_int4
from voxtral_tpu_torch.tools.profile_int4_unpack import T5_CHECK_RTOL

torch.set_num_threads(2)

TILE, SUB, ROW, SCORE_ROW = 16, 2, 64, 2120   # kT5Tile, kT5Sub, kT5Row, kT5ScoreRow
UNPACK_FNS = ["unpack", "kern4", "attn4"]


SMS = 132


def _resident(per_sm, sms=SMS):
    """Resident blocks for clusters of 1..8: `per_sm` blocks on each SM,
    fewer for clusters that do not pack the card's GPCs."""
    return [max(c, per_sm * sms - (c - 1) * 8) for c in range(1, 9)]


# --- (a) the rounding points ----------------------------------------------

def _emulate(q, krp, vrp, sms, resident):
    """T5's arithmetic in plain torch: q bf16 [b, 1, 8 C], packed rings int8
    [b, p, C]. s is one 128-deep f32 product (low nibbles = lanes 0-63,
    high = 64-127); each split of the plan takes its max, the global max is
    the max of those; e = bf16(exp(s - max)) once; each split's f32 partial
    e . v is added in split order; the sum is rounded to bf16. Returns
    (output, splits)."""
    b, p, c = krp.shape
    hkv = c // ROW
    share, splits = la.t5_plan(b, p, hkv, sms, resident)
    qh = q.float().reshape(b, hkv, 4, 128)

    def lanes(r):                                   # -> f32 [b, hkv, p, 128]
        lo, hi = unpack_int4(r.reshape(b, p, hkv, ROW))
        return torch.cat([lo, hi], -1).float().transpose(1, 2)

    k, v = lanes(krp), lanes(vrp)
    s = qh @ k.transpose(-1, -2)                    # [b, hkv, 4, p]
    cuts = [slice(r * share, min(p, (r + 1) * share)) for r in range(splits)]
    m = torch.stack([s[..., cut].amax(-1) for cut in cuts]).amax(0)[..., None]
    e = torch.exp(s - m).to(torch.bfloat16).float()
    out = e[..., cuts[0]] @ v[:, :, cuts[0]]
    for cut in cuts[1:]:
        out = out + e[..., cut] @ v[:, :, cut]
    return out.reshape(b, 1, -1).to(torch.bfloat16), splits


@pytest.mark.parametrize("unpack", ["i32", "f32"])
@pytest.mark.parametrize("p,sms,splits", [(37, 16, 1), (37, SMS, 3), (300, SMS, 7)])
def test_t5_rounding_matches_pallas_kernel(interpret, unpack, p, sms, splits):
    """The emulated route against the tool's attn4 (interpret mode) on
    packed bytes over the whole int8 range, P ragged against the 16-slot
    tile (37 = 2 x 16 + 5; 300 = 18 x 16 + 12), one split (a card whose 16
    SMs the 16 (stream, head) pairs already cover) or several."""
    b, kv = 2, 1024
    rng = np.random.RandomState(p + sms)
    q = rng.randn(b, 1, 4 * kv) * 0.05
    qj = jnp.asarray(q, jnp.bfloat16)
    qt = torch.from_numpy(np.array(qj.astype(jnp.float32))).to(torch.bfloat16)
    krp, vrp = (rng.randint(-128, 128, size=(b, p, kv // 2)).astype(np.int8) for _ in range(2))
    tool = _tool_functions("profile_int4_unpack.py", UNPACK_FNS, B=b, P=p, HD=128, GROUP=4,
                           BLK=512, UNPACK=unpack)
    want = np.asarray(tool["attn4"](qj, jnp.asarray(krp), jnp.asarray(vrp))
                      .astype(jnp.float32))
    got, n = _emulate(qt, torch.from_numpy(krp), torch.from_numpy(vrp), sms, _resident(4))
    assert n == splits
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=T5_CHECK_RTOL * np.abs(want).max())
    plain = la.attn4(qt, torch.from_numpy(krp), torch.from_numpy(vrp))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), rtol=0,
                               atol=T5_CHECK_RTOL * np.abs(want).max())


# --- (b) the fragment mapping, lane by lane --------------------------------

def _t5_off(j, c):
    return (j >> 1) * 128 + 16 * ((((j & 1) << 2) | c) ^ (((j >> 1) & 3) << 1))


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes of (x, y)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16_pair(bits):
    """A 32-bit word as two bf16 values (low half first)."""
    return [float(np.array([((bits >> sh) & 0xFFFF) << 16], np.uint32).view(np.float32)[0])
            for sh in (0, 16)]


def _lo(w):
    return (w ^ 0x88888888) & 0x0F0F0F0F


def _hi(w):
    return ((w ^ 0x88888888) >> 4) & 0x0F0F0F0F


def _nibbles_to_bf16(u):
    """mma_common::nibbles_to_bf16: pairs (bytes 0, 1) and (2, 3), each
    (128 + byte) - 136 per half (exact in bf16)."""
    return [[x - 136.0 for x in _bf16_pair(_byte_perm(u, 0x43, sel))] for sel in (0x4140, 0x4342)]


def _word(mem, off):
    return int(mem[off:off + 4].view(np.uint32)[0])


def _mma(a, b0, b1):
    """mma.sync m16n8k16 on lane fragments (exact, f64): a [32][4] pairs,
    b0, b1 [32] pairs -> C [32][4]."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, 2 * t:2 * t + 2], A[g + 8, 2 * t:2 * t + 2] = a[lane][0], a[lane][1]
        A[g, 2 * t + 8:2 * t + 10], A[g + 8, 2 * t + 8:2 * t + 10] = a[lane][2], a[lane][3]
        B[2 * t:2 * t + 2, g], B[2 * t + 8:2 * t + 10, g] = b0[lane], b1[lane]
    C = A @ B
    return [[C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]
            for g, t in ((lane >> 2, lane & 3) for lane in range(32))]


def _conflict_free(addrs, width):
    """One warp-wide shared access of `width` bytes a lane (None: inactive):
    each phase (128 bytes' worth of lanes) touches every bank at most once."""
    per_phase = 128 // width
    for ph in range(0, 32, per_phase):
        banks = []
        for a in addrs[ph:ph + per_phase]:
            if a is not None:
                assert a % width == 0
                banks += [(a // 4 + i) % 32 for i in range(width // 4)]
        if len(banks) != len(set(banks)):
            return False
    return True


def _copy_stage(rows, count):
    """A warp's cp.async.cg of one stage of SUB tiles: lane L copies chunk
    L % 4 of rows L / 4 and L / 4 + 8 of each tile; rows past `count` are
    zero-filled."""
    mem = np.zeros(SUB * TILE * ROW, np.uint8)
    for s in range(SUB):
        dst = [[], []]
        for lane in range(32):
            crow, cchunk = lane >> 2, lane & 3
            for e, row in enumerate((crow, crow + 8)):
                off = s * TILE * ROW + _t5_off(row, cchunk)
                dst[e].append(off)
                if TILE * s + row < count:
                    mem[off:off + 16] = rows[TILE * s + row, 16 * cchunk:16 * cchunk + 16].view(np.uint8)
        assert all(_conflict_free(d, 16) for d in dst)
    return mem


@pytest.mark.parametrize("sub", range(SUB))
def test_t5_fragment_mapping_emulated(sub):
    """Tile `sub` of a stage, in each pass, as a warp of the kernel sees
    it, at a ragged count (29 of the stage's 32 slots): S^T = K Q^T must
    equal the codes' scores and O^T = V^T P^T must equal e . v exactly,
    every lane's loads conflict free. Codes over the whole int4 range, q and
    e exact in bf16."""
    rng = np.random.RandomState(12 + sub)
    count = 29
    stage_k, stage_v = (rng.randint(-8, 8, size=(SUB * TILE, 128)).astype(np.int8)
                        for _ in range(2))
    stage_k[count:] = 0
    stage_v[count:] = 0
    kstage = _copy_stage(pack_int4(torch.from_numpy(stage_k)).numpy(), count)
    vstage = _copy_stage(pack_int4(torch.from_numpy(stage_v)).numpy(), count)
    codes_k = stage_k[TILE * sub:TILE * (sub + 1)]
    codes_v = stage_v[TILE * sub:TILE * (sub + 1)]
    kmem = kstage[TILE * ROW * sub:TILE * ROW * (sub + 1)]
    vmem = vstage[TILE * ROW * sub:TILE * ROW * (sub + 1)]
    q = rng.randint(-64, 64, size=(4, 128)) / 64.0            # bf16-exact
    e = rng.randint(0, 129, size=(4, TILE)) / 128.0           # bf16-exact
    e[:, max(0, count - TILE * sub):] = 0.0

    # pass 1: S^T
    qf = {}                                          # (lane, k-step) -> b0, b1 pairs
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            for n in range(2):
                lanes = 64 * n + 16 * t + 4 * i
                w = q[g, lanes:lanes + 4] if g < 4 else np.zeros(4)
                qf[lane, 2 * i + n] = (list(w[:2]), list(w[2:]))
    c = [[0.0] * 4 for _ in range(32)]
    k_addrs = [[_t5_off(lane >> 2, lane & 3) for lane in range(32)],
               [_t5_off((lane >> 2) + 8, lane & 3) for lane in range(32)]]
    assert all(_conflict_free(a, 16) for a in k_addrs)
    for wi in range(4):
        for n in range(2):
            a = []
            for lane in range(32):
                pairs = []
                for addrs in k_addrs:                # slot g, then g + 8
                    w = _word(kmem, addrs[lane] + 4 * wi)
                    pairs.append(_nibbles_to_bf16(_hi(w) if n else _lo(w)))
                a.append([pairs[0][0], pairs[1][0], pairs[0][1], pairs[1][1]])
            b0 = [qf[lane, 2 * wi + n][0] for lane in range(32)]
            b1 = [qf[lane, 2 * wi + n][1] for lane in range(32)]
            step = _mma(a, b0, b1)
            c = [[x + y for x, y in zip(cl, sl)] for cl, sl in zip(c, step)]
    scores = np.zeros((4, TILE))
    store_addrs = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if t < 2:
            for idx, (head, slot) in enumerate(((2 * t, g), (2 * t + 1, g), (2 * t, g + 8),
                                                (2 * t + 1, g + 8))):
                scores[head, slot] = c[lane][idx]
                store_addrs.setdefault(idx, [None] * 32)[lane] = 4 * (head * SCORE_ROW + slot)
        else:
            assert c[lane] == [0.0] * 4              # the padding heads 4-7
    assert all(_conflict_free(a, 4) for a in store_addrs.values())
    np.testing.assert_array_equal(scores, q @ codes_k.astype(np.float64).T)

    # pass 2: O^T
    pb = []
    load_addrs = [[None] * 32, [None] * 32]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if g < 4:
            for p in range(2):
                load_addrs[p][lane] = 4 * (g * SCORE_ROW + 8 * p + 2 * t)
            pb.append((list(e[g, 2 * t:2 * t + 2]), list(e[g, 2 * t + 8:2 * t + 10])))
        else:
            pb.append(([0.0, 0.0], [0.0, 0.0]))
    assert all(_conflict_free(a, 8) for a in load_addrs)
    v_addrs = {(p, ee): [_t5_off(2 * (lane & 3) + 8 * p + ee, (lane >> 2) >> 1)
                         + 8 * ((lane >> 2) & 1) for lane in range(32)]
               for p in range(2) for ee in range(2)}
    assert all(_conflict_free(a, 8) for a in v_addrs.values())
    out = np.full((4, 128), np.nan)
    for hb in range(2):
        for sel in range(2):
            for nib in range(2):
                mt = 4 * hb + 2 * sel + nib
                a = []
                for lane in range(32):
                    conv = []
                    for p in range(2):
                        wa = _word(vmem, v_addrs[p, 0][lane] + 4 * hb)
                        wb = _word(vmem, v_addrs[p, 1][lane] + 4 * hb)
                        x = _byte_perm(wa, wb, 0x7362 if sel else 0x5140)
                        conv.append(_nibbles_to_bf16(_hi(x) if nib else _lo(x)))
                    a.append([conv[0][0], conv[0][1], conv[1][0], conv[1][1]])
                o = _mma(a, [pb[lane][0] for lane in range(32)], [pb[lane][1] for lane in range(32)])
                for lane in range(32):                # the epilogue's lanes
                    g, t = lane >> 2, lane & 3
                    if t < 2:
                        d = 8 * g + 4 * hb + 2 * sel + 64 * nib
                        assert d == 8 * g + 4 * (mt >> 2) + 2 * ((mt >> 1) & 1) + 64 * (mt & 1)
                        out[2 * t, d], out[2 * t, d + 1] = o[lane][0], o[lane][2]
                        out[2 * t + 1, d], out[2 * t + 1, d + 1] = o[lane][1], o[lane][3]
    np.testing.assert_array_equal(out, e @ codes_v.astype(np.float64))
    assert np.abs(out).max() > 0


# --- (c) the plan and the refusals ------------------------------------------

PLAN_CASES = [(32, 2088, 8), (64, 2088, 8), (64, 1500, 8), (16, 2088, 8), (8, 2088, 8),
              (1, 2088, 8), (1, 1, 8), (3, 15, 8), (5, 300, 4), (4, 300, 1), (1, 16768, 8),
              (64, 16768, 8), (2, 2097, 1), (17, 2088, 8)]


@pytest.mark.parametrize("b,p,hkv", PLAN_CASES)
@pytest.mark.parametrize("per_sm", [1, 3, 5, 8])
def test_t5_plan_splits_p(b, p, hkv, per_sm):
    """Whole 16-slot tiles, at most 2096 slots a share, 1-8 splits that
    cover P with none empty and no fewer than 2096-slot shares need; above
    that, a grid within one wave of the resident blocks, and fewer splits
    would not cover every SM."""
    resident = _resident(per_sm)
    share, splits = la.t5_plan(b, p, hkv, SMS, resident)
    assert share % TILE == 0 and TILE <= share <= 2096 and 1 <= splits <= 8
    assert share * (splits - 1) < p <= share * splits          # covered, none empty
    need = -(-p // 2096)
    assert splits >= need
    if splits > need:
        assert b * hkv * splits <= resident[splits - 1]         # one wave
        assert b * hkv * (splits - 1) < SMS                     # the fewest that cover the SMs
    assert la.t5_plan(b, p, hkv, SMS, resident) == (share, splits)


def test_t5_plan_at_the_tool_shapes():
    """At 3 blocks an SM (T5's residency on the H100): the timed shape (B
    32, P 2088, 8 kv heads) takes one split of 131 tiles (256 blocks); B
    16 two (256 blocks); one stream 8 splits; one slot one split; B 64 at P
    1500 one split (no cluster); the largest P, 8 shares of 2096, even at a
    batch beyond one wave."""
    resident = _resident(3)
    assert la.t5_plan(32, 2088, 8, SMS, resident) == (2096, 1)
    assert la.t5_plan(16, 2088, 8, SMS, resident) == (1056, 2)
    assert la.t5_plan(1, 2088, 8, SMS, resident) == (272, 8)
    assert la.t5_plan(1, 1, 8, SMS, resident) == (16, 1)
    assert la.t5_plan(64, 1500, 8, SMS, resident) == (1504, 1)
    assert la.t5_plan(64, 16768, 8, SMS, resident) == (2096, 8)
    assert la.T5_MAX_SLOTS == 16768


@pytest.mark.parametrize("b,p,hkv,match", [(1, 0, 8, "slots"), (1, 16769, 8, "slots"),
                                           (0, 10, 8, "streams"), (1, 10, 0, "kv heads")])
def test_t5_plan_refuses(b, p, hkv, match):
    with pytest.raises(ValueError, match=match):
        la.t5_plan(b, p, hkv, SMS, _resident(3))


def test_t5_entry_refuses_before_the_card(monkeypatch):
    """The entry refuses what T5 cannot take (P beyond 16768, a ring that
    is not whole 64-byte heads, q of another shape or dtype, codes not
    int8, no streams) with ValueError before it asks for the card: the
    library and the occupancy query are stubbed to fail. A takeable call
    on CPU tensors is refused for its device."""
    def no_card(*_a, **_k):
        raise AssertionError("reached the card")

    monkeypatch.setattr(la, "_lib", no_card)
    monkeypatch.setattr(la, "_resident", no_card)

    def args(b=2, p=16, kv=512, qdt=torch.bfloat16, kdt=torch.int8):
        return (torch.zeros((b, 1, 4 * kv), dtype=qdt), torch.zeros((b, p, kv // 2), dtype=kdt),
                torch.zeros((b, p, kv // 2), dtype=kdt))

    q, k, v = args()
    cases = [
        (args(p=16769), "takes 1..16768"),
        ((q, torch.zeros((2, 16, 96), dtype=torch.int8),
          torch.zeros((2, 16, 96), dtype=torch.int8)), "rings"),
        ((q, k, torch.zeros((2, 15, 256), dtype=torch.int8)), "rings"),
        ((torch.zeros((2, 1, 1024), dtype=torch.bfloat16), k, v), "does not match"),
        (args(qdt=torch.float32), "takes torch.bfloat16"),
        (args(kdt=torch.uint8), "takes torch.int8"),
        (args(b=0), "0 streams"),
        (args(kv=0), "0 kv heads"),
        ((q, k, v), "needs CUDA tensors"),           # takeable, but not on a card
    ]
    for call_args, match in cases:
        with pytest.raises(ValueError, match=match):
            la.attn4_kernel(*call_args)
    assert la.LAUNCHES["attn4"] == 0


def test_t5_variant_sources_change_one_choice_each(tmp_path):
    """The design sweep's variant copies of layout_attention.cu: a variant
    without edits (the committed one, and a change of the plan alone) is
    the source itself, every edited one differs from it and from the
    others, an edit that no longer matches the source raises, and the
    sweep refuses to run off the card."""
    dirs = t5v.variant_sources(str(tmp_path))
    with open(os.path.join(t5v._build.CSRC_DIR, "layout_attention.cu")) as f:
        committed = f.read()
    texts = {}
    for v, d in dirs.items():
        with open(os.path.join(d, "layout_attention.cu")) as f:
            texts[v] = f.read()
    edited = {v: t for v, t in texts.items() if t5v.VARIANTS[v][3]}
    assert all(texts[v] == committed for v in texts if v not in edited)
    assert committed not in edited.values() and len(set(edited.values())) == len(edited) >= 10
    assert all(os.path.exists(os.path.join(d, "mma_common.cuh")) for d in dirs.values())
    stale = (2096, 8, None, [("no such line", "x", 1)], True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(t5v.VARIANTS, "stale", stale)
        with pytest.raises(ValueError, match="occurs 0 times"):
            t5v.variant_sources(str(tmp_path), names=("stale",))
    with pytest.raises(ValueError, match="needs the card"):
        t5v.profile_t5_variants(device="cpu")
