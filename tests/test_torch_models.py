"""The port's encoder, adapter, decoder and offline pipeline
(voxtral_tpu_torch.models) against the golden fixtures and the JAX package,
tiny config, f32 on the CPU (where the ring attention wrapper runs its plain
version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from voxtral_tpu import models as jm
from voxtral_tpu.models.pipeline import transcribe_tokens_batch as jax_transcribe
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch import models as tm
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.decoder import reset_streams
from voxtral_tpu_torch.models.pipeline import (
    prompt_token_ids, transcribe_tokens_batch,
)
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def params(tiny_cfg):
    return from_numpy_params(jax_random_params(tiny_cfg, 1234, numpy_out=True), CPU)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def test_encoder_and_adapter_match_fixture_and_jax(cfg, tiny_cfg, params, tiny_params):
    g = load_fixture("encoder.npz")
    h = tm.conv_stem(params["encoder"], _t(g["mel"]))
    trunc = h.shape[0] % cfg.downsample
    enc = tm.encoder_forward(params["encoder"], cfg, h[trunc:])
    np.testing.assert_allclose(enc.numpy(), g["enc_out"], atol=2e-5, rtol=1e-4)
    jh = jm.conv_stem(tiny_params["encoder"], jnp.asarray(g["mel"]))
    jenc = jm.encoder_forward(tiny_params["encoder"], tiny_cfg, jh[trunc:])
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=1e-5, rtol=1e-5)
    ada = tm.adapter_forward(params["adapter"], cfg, _t(g["enc_out"]))
    np.testing.assert_allclose(ada.numpy(), g["adapter_out"], atol=2e-5, rtol=1e-4)
    jada = jm.adapter_forward(tiny_params["adapter"], tiny_cfg,
                              jnp.asarray(g["enc_out"]))
    np.testing.assert_allclose(ada.numpy(), np.asarray(jada), atol=1e-5, rtol=1e-5)


def test_time_conditioning_and_ada_scales(cfg, tiny_cfg, params, tiny_params):
    g = load_fixture("decoder.npz")
    tc = tm.time_conditioning(cfg.streaming.delay_tokens, cfg.decoder.dim)
    np.testing.assert_allclose(tc.numpy(), g["t_cond"], atol=1e-6)
    jtc = jm.time_conditioning(6, tiny_cfg.decoder.dim)
    # same f32 order as JAX; exp/cos/sin may differ by one ulp
    np.testing.assert_allclose(tc.numpy(), np.asarray(jtc), atol=2e-7, rtol=0)
    np.testing.assert_allclose(
        tm.ada_scales(params["decoder"], tc).numpy(),
        np.asarray(jm.ada_scales(tiny_params["decoder"], jtc)), atol=1e-6)


def _prefilled(cfg, params, adapter, **state_kw):
    """Port decoder state after the prompt prefill, as tests/test_decoder.py."""
    g = load_fixture("decoder.npz")
    prompt = prompt_token_ids(cfg, cfg.streaming.delay_tokens)
    lp = len(prompt)
    t_ada = tm.ada_scales(params["decoder"], _t(g["t_cond"]))
    embed = params["decoder"]["embed"]
    prefix = _t(adapter[:lp - 1]) + embed[_t(prompt[:lp - 1]).long()].float()
    state = tm.init_decode_state(cfg, batch=1, device=CPU, **state_kw)
    state = tm.decoder_prefill(params["decoder"], cfg, state, prefix[None], t_ada)
    state = state._replace(prev_token=_t(prompt[-1:]))
    return state, t_ada, adapter[lp - 1:]


def _run_decode(cfg, params, adapter, batch_pad=0, collect_topk=8):
    state, t_ada, frames = _prefilled(cfg, params, adapter)
    n = len(frames)
    padded = np.zeros((n + batch_pad, adapter.shape[1]), np.float32)
    padded[:n] = frames
    state, tokens, aux = tm.decode_scan(
        params["decoder"], cfg, state, _t(padded)[None],
        torch.tensor([n], dtype=torch.int32), t_ada,
        collect_topk=collect_topk, stop_at_eos=False)
    return tokens[0].numpy(), aux


def test_decoder_tokens_and_logits_match_fixture(cfg, params):
    g = load_fixture("decoder.npz")
    tokens, aux = _run_decode(cfg, params, g["adapter"])
    np.testing.assert_array_equal(tokens, g["tokens"])
    vals, idxs = aux["topk_vals"][0].numpy(), aux["topk_idx"][0].numpy()
    best = aux["best_logit"][0].numpy()
    ns = cfg.streaming.n_special
    for step, ref in enumerate(g["logits"]):
        assert (idxs[step] >= ns).all() and (idxs[step] != tokens[step]).all()
        np.testing.assert_allclose(vals[step], ref[idxs[step]], atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(best[step], ref[tokens[step]], atol=2e-4, rtol=1e-3)


def test_bucket_padding_is_inert(cfg, params):
    g = load_fixture("decoder.npz")
    tok_a, _ = _run_decode(cfg, params, g["adapter"], collect_topk=0)
    tok_b, _ = _run_decode(cfg, params, g["adapter"], batch_pad=9, collect_topk=0)
    np.testing.assert_array_equal(tok_a, tok_b[:len(tok_a)])
    assert (tok_b[len(tok_a):] == -1).all()


def test_split_decode_equals_single_scan(cfg, params):
    g = load_fixture("decoder.npz")
    state, t_ada, frames = _prefilled(cfg, params, g["adapter"])
    toks, pos = [], 0
    for size in (1, 5, 2, 9, 5):
        state, t, _ = tm.decode_scan(
            params["decoder"], cfg, state, _t(frames[pos:pos + size])[None],
            torch.tensor([size], dtype=torch.int32), t_ada, stop_at_eos=False)
        toks.append(t[0].numpy())
        pos += size
    np.testing.assert_array_equal(np.concatenate(toks), g["tokens"])


def test_long_decode_ring_size_invariance_and_jax(cfg, tiny_cfg, params, tiny_params):
    """A minimal ring that wraps many times decodes the same tokens as a ring
    that never wraps, and as the JAX package's decoder."""
    rng = np.random.RandomState(7)
    d = cfg.decoder
    n = 120
    frames = (rng.randn(1, n, d.dim) * 0.1).astype(np.float32)
    prefix = (rng.randn(1, 4, d.dim) * 0.1).astype(np.float32)

    def run_port(ring_size):
        t_ada = tm.ada_scales(params["decoder"], tm.time_conditioning(6, d.dim))
        state = tm.init_decode_state(cfg, batch=1, ring_size=ring_size,
                                     pending_size=8, device=CPU)
        state = tm.decoder_prefill(params["decoder"], cfg, state, _t(prefix), t_ada)
        toks = []
        for c0 in range(0, n, 8):
            state, t, _ = tm.decode_scan(
                params["decoder"], cfg, state, _t(frames[:, c0:c0 + 8]),
                torch.tensor([8], dtype=torch.int32), t_ada, stop_at_eos=False)
            toks.append(t[0].numpy())
        return np.concatenate(toks)

    def run_jax(ring_size):
        t_ada = jm.ada_scales(tiny_params["decoder"], jm.time_conditioning(6, d.dim))
        state = jm.init_decode_state(tiny_cfg, batch=1, ring_size=ring_size,
                                     pending_size=8)
        state = jm.decoder_prefill(tiny_params["decoder"], tiny_cfg, state,
                                   jnp.asarray(prefix), t_ada)
        toks = []
        for c0 in range(0, n, 8):
            state, t, _ = jm.decode_scan(
                tiny_params["decoder"], tiny_cfg, state,
                jnp.asarray(frames[:, c0:c0 + 8]), jnp.asarray([8], jnp.int32),
                t_ada, stop_at_eos=False)
            toks.append(np.asarray(t[0]))
        return np.concatenate(toks)

    small = run_port(d.window + 8)
    np.testing.assert_array_equal(small, run_port(512))
    np.testing.assert_array_equal(small, run_jax(d.window + 8))


def test_prefill_longer_than_ring_matches_jax(cfg, tiny_cfg, params, tiny_params):
    """decoder_prefill with S > ring keeps the last `ring` rows, rolled so
    slot j holds position j mod ring; then decoding continues identically."""
    rng = np.random.RandomState(21)
    d = cfg.decoder
    s = 100                              # > ring 96 = window 32 + Np 64
    prefix = (rng.randn(1, s, d.dim) * 0.1).astype(np.float32)
    frames = (rng.randn(1, 12, d.dim) * 0.1).astype(np.float32)
    t_ada = tm.ada_scales(params["decoder"], tm.time_conditioning(6, d.dim))
    j_ada = jm.ada_scales(tiny_params["decoder"], jm.time_conditioning(6, d.dim))
    st = tm.init_decode_state(cfg, device=CPU)
    st = tm.decoder_prefill(params["decoder"], cfg, st, _t(prefix), t_ada)
    js = jm.init_decode_state(tiny_cfg)
    js = jm.decoder_prefill(tiny_params["decoder"], tiny_cfg, js,
                            jnp.asarray(prefix), j_ada)
    assert st.k_ring[0].shape[1] == js.k_ring[0].shape[1] == 160
    np.testing.assert_array_equal(st.slot_pos.numpy(), np.asarray(js.slot_pos))
    for l in range(d.layers):
        np.testing.assert_allclose(st.k_ring[l].numpy(), np.asarray(js.k_ring[l]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(st.v_ring[l].numpy(), np.asarray(js.v_ring[l]),
                                   atol=1e-5, rtol=1e-5)
    assert int(st.write_ctr) == int(js.write_ctr) == s
    st, t, _ = tm.decode_scan(params["decoder"], cfg, st, _t(frames),
                              torch.tensor([12], dtype=torch.int32), t_ada,
                              stop_at_eos=False)
    js, jt, _ = jm.decode_scan(tiny_params["decoder"], tiny_cfg, js,
                               jnp.asarray(frames), jnp.asarray([12], jnp.int32),
                               j_ada, stop_at_eos=False)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_forced_tokens_topk_and_packed_aux_match_jax(cfg, tiny_cfg, params, tiny_params):
    """A batch of two streams with different backlogs, forced tokens, EOS
    stop and top-k: tokens, state and the packed aux wire equal JAX's, and
    reset_streams acts alike."""
    rng = np.random.RandomState(5)
    d = cfg.decoder
    b, n = 2, 70                          # > Np: two segments
    frames = (rng.randn(b, n, d.dim) * 0.1).astype(np.float32)
    prefix = (rng.randn(b, 6, d.dim) * 0.1).astype(np.float32)
    forced = np.full((b, n), -1, np.int32)
    forced[0, 3:6] = [5, 2, 7]            # includes EOS: stream 0 stops
    forced[1, 60:62] = [11, 12]
    n_valid = np.array([n, 50], np.int32)
    t_ada = tm.ada_scales(params["decoder"], tm.time_conditioning(6, d.dim))
    j_ada = jm.ada_scales(tiny_params["decoder"], jm.time_conditioning(6, d.dim))
    st = tm.init_decode_state(cfg, batch=b, device=CPU)
    st = tm.decoder_prefill(params["decoder"], cfg, st, _t(prefix), t_ada)
    st, tok, aux = tm.decode_scan(params["decoder"], cfg, st, _t(frames),
                                  _t(n_valid), t_ada, collect_topk=4,
                                  forced_tokens=_t(forced))
    js = jm.init_decode_state(tiny_cfg, batch=b)
    js = jm.decoder_prefill(tiny_params["decoder"], tiny_cfg, js,
                            jnp.asarray(prefix), j_ada)
    js, jtok, jaux = jm.decode_scan(tiny_params["decoder"], tiny_cfg, js,
                                    jnp.asarray(frames), jnp.asarray(n_valid),
                                    j_ada, collect_topk=4,
                                    forced_tokens=jnp.asarray(forced))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert (tok.numpy()[0, 5:] == -1).all()           # done after forced EOS
    packed, jpacked = aux["packed"].numpy(), np.asarray(jaux["packed"])
    assert packed.shape == jpacked.shape == (b, n, 10)
    ints = np.r_[0, 6:10]                             # token and index columns
    np.testing.assert_array_equal(packed[..., ints].view(np.int32),
                                  jpacked[..., ints].view(np.int32))
    np.testing.assert_allclose(packed[..., 1:6], jpacked[..., 1:6], atol=1e-5, rtol=1e-5)
    for name in ("pos", "prev_token", "done", "write_ctr", "pending_adv",
                 "pending_sp", "slot_pos"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    mask = np.array([True, False])
    rs = reset_streams(st, _t(mask))
    jrs = jm.decoder.reset_streams(js, jnp.asarray(mask))
    for name in ("pos", "prev_token", "done", "pending_sp", "slot_pos"):
        np.testing.assert_array_equal(getattr(rs, name).numpy(),
                                      np.asarray(getattr(jrs, name)), err_msg=name)


def test_init_decode_state_layout_and_int8_refusal(cfg, tiny_cfg):
    st = tm.init_decode_state(cfg, batch=3, ring_size=37, pending_size=5, device=CPU)
    js = jm.init_decode_state(tiny_cfg, batch=3, ring_size=37, pending_size=5)
    assert st.k_ring[0].shape == js.k_ring[0].shape      # 32-aligned physical
    assert st.pending_k[0].shape == js.pending_k[0].shape
    with pytest.raises(NotImplementedError, match="fleet slice"):
        tm.init_decode_state(cfg, kv_dtype="int8", device=CPU)


def test_pipeline_tokens_match_fixture_and_jax(cfg, tiny_cfg, params, tiny_params):
    g = load_fixture("pipeline.npz")
    tokens, aux = transcribe_tokens_batch(params, cfg, g["audio"], collect_topk=4,
                                          device=CPU)
    ref = list(g["tokens"])
    if 2 in ref:
        ref = ref[:ref.index(2)]
    assert tokens == ref
    jtokens, jaux = jax_transcribe(tiny_params, tiny_cfg, g["audio"], collect_topk=4)
    assert tokens == jtokens
    np.testing.assert_allclose(aux["packed"].numpy(), np.asarray(jaux["packed"]),
                               atol=1e-5, rtol=1e-5)


def test_pipeline_long_clip_crosses_segments_like_jax(cfg, tiny_cfg, params, tiny_params):
    """A 6 s clip decodes > 64 steps, so decode_scan runs several segments."""
    rng = np.random.RandomState(8)
    audio = (rng.randn(6 * 16000) * 0.1).astype(np.float32)
    tokens, aux = transcribe_tokens_batch(params, cfg, audio, collect_topk=2,
                                          device=CPU)
    assert aux["best_logit"].shape[1] > 64
    jtokens, _ = jax_transcribe(tiny_params, tiny_cfg, audio)
    assert tokens == jtokens


def test_pipeline_default_device_needs_cuda(cfg, params):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transcribe_tokens_batch(params, cfg, np.zeros(16000, np.float32))
