"""The port's host code for text: the Tekken tokenizer
(voxtral_tpu_torch.tokenizer) and the alt-token cutoff walk
(voxtral_tpu_torch.runtime.alts.select_alts) against the JAX package's
copies, on toy tekken.json files and seeded logits."""

import base64
import json

import numpy as np
import pytest
import torch

from voxtral_tpu.runtime.alts import select_alts as jax_select_alts
from voxtral_tpu.tokenizer import Tokenizer as JaxTokenizer
from voxtral_tpu.tokenizer import make_test_tokenizer_json as jax_make_json
from voxtral_tpu_torch.models.decoder import alt_candidates
from voxtral_tpu_torch.runtime.alts import select_alts
from voxtral_tpu_torch.tokenizer import Tokenizer, make_test_tokenizer_json

torch.set_num_threads(2)


@pytest.mark.parametrize("vocab_size", [1, 95, 200])
def test_test_tokenizer_json_and_decode_match(tmp_path, vocab_size):
    """Both packages write the same toy file, and read it the same way:
    every id's bytes, pieces, text class and whole-sequence decode."""
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    make_test_tokenizer_json(str(ours), vocab_size=vocab_size)
    jax_make_json(str(theirs), vocab_size=vocab_size)
    assert ours.read_bytes() == theirs.read_bytes()
    tok, ref = Tokenizer(str(ours)), JaxTokenizer(str(theirs))
    assert (tok.n_special, tok.vocab_size, tok.special_ids) == \
        (ref.n_special, ref.vocab_size, ref.special_ids)
    assert (tok.bos, tok.eos, tok.streaming_pad) == (ref.bos, ref.eos, ref.streaming_pad)
    ids = list(range(tok.vocab_size + 5))
    for i in ids:
        assert tok.token_bytes(i) == ref.token_bytes(i)
        assert tok.decode_piece(i) == ref.decode_piece(i)
        assert tok.is_text(i) == ref.is_text(i)
    rng = np.random.RandomState(vocab_size)
    seq = [int(x) for x in rng.randint(0, tok.vocab_size + 5, 64)]
    assert tok.decode(seq) == ref.decode(seq)
    assert tok.is_text(100) and not tok.is_text(2)


def _split_utf8_file(path):
    """A vocab whose pieces split 'é' (c3 a9) and '€' (e2 82 ac) across
    tokens."""
    pieces = [b"caf", b"\xc3", b"\xa9", b"\xe2", b"\x82\xac", b" ok"]
    path.write_text(json.dumps({
        "config": {"default_num_special_tokens": 100},
        "special_tokens": [{"rank": 1, "token_str": "<s>"}],
        "vocab": [{"rank": i, "token_bytes": base64.b64encode(b).decode()}
                  for i, b in enumerate(pieces)]}))
    return str(path)


def test_stream_decoder_split_utf8_matches(tmp_path):
    """A multi-byte character split across tokens: the incremental decoder
    gives the same pieces as the JAX one, completing the character with
    its last byte; a dangling half flushes to U+FFFD in both."""
    path = _split_utf8_file(tmp_path / "tekken.json")
    tok, ref = Tokenizer(path), JaxTokenizer(path)
    ids = [100, 101, 102, 1, 103, 104, 105]
    assert tok.decode(ids) == ref.decode(ids) == "café€ ok"
    sd, rd = tok.stream_decoder(), ref.stream_decoder()
    pieces = [sd.piece(i) for i in ids]
    assert pieces == [rd.piece(i) for i in ids]
    assert pieces == ["caf", "", "é", "", "", "€", " ok"]
    assert sd.flush() == rd.flush() == ""
    sd, rd = tok.stream_decoder(), ref.stream_decoder()
    assert sd.piece(103) == rd.piece(103) == ""
    assert sd.flush() == rd.flush() == "�"


@pytest.mark.parametrize("n_alt,cutoff", [(2, 0.5), (3, 0.95), (4, 1.0), (4, 0.0)])
def test_select_alts_matches(n_alt, cutoff):
    """select_alts on the port's device top-k of seeded logits (near ties,
    specials boosted, and rows whose candidates run out into -inf) equals
    the JAX function's choice on the same numbers."""
    rng = np.random.RandomState(n_alt * 7 + int(cutoff * 10))
    b, v, n_special = 6, 48, 8
    logits = rng.randn(b, v).astype(np.float32)
    logits[0, :n_special] += 10.0                     # specials dominate
    logits[1, 20:24] = logits[1].max() - 1e-3          # near ties
    logits[2, n_special:] = -np.inf                    # no candidates at all
    logits[2, 10] = 3.0
    logits[3, n_special + 2:] = -np.inf                # fewer than k left
    t = torch.from_numpy(logits)
    tok = torch.argmax(t[:, n_special:], dim=1).to(torch.int32) + n_special
    k = max(1, n_alt - 1) + 2
    vals, idx, best = (x.numpy() for x in alt_candidates(t, tok, n_special, k))
    assert np.isinf(vals[2]).any() and np.isinf(vals[3]).any()
    picks = []
    for r in range(b):
        got = select_alts(best[r], vals[r], idx[r], n_alt, cutoff)
        assert got == jax_select_alts(best[r], vals[r], idx[r], n_alt, cutoff)
        assert len(got) <= n_alt - 1 and int(tok[r]) not in got
        assert all(j >= n_special for j in got)
        picks.append(got)
    if cutoff >= 0.95:
        assert any(picks)
