"""Tekken tokenizer (decode-only), pure Python: a copy of
`voxtral_tpu/tokenizer.py` (the port keeps its own, so it imports nothing
of the JAX package).

ID scheme (voxtral_tokenizer.c:4-14, python_simple_implementation.py:670-719):
ids < n_special (default 1000) are special/control tokens that decode to
nothing; id >= n_special maps to vocab[id - n_special].token_bytes (base64).
Token pieces are raw UTF-8 byte fragments; multi-token sequences must be
concatenated at the byte level before decoding.
"""

from __future__ import annotations

import base64
import codecs
import json


class StreamDecoder:
    """Incremental UTF-8 token-piece decoder for the streaming path.

    Byte-level BPE routinely splits a multi-byte UTF-8 character across
    tokens; decoding each piece independently would emit U+FFFD for both
    halves. This keeps the partial bytes buffered (codecs incremental
    decoder), so piece(a) + piece(b) concatenate to the correct character —
    the same result as the reference CLI writing raw token bytes to stdout
    (main.c:49-105, byte-level concatenation happens in the terminal)."""

    def __init__(self, tok: "Tokenizer"):
        self._tok = tok
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def piece(self, token_id: int) -> str:
        """Text completed by this token (may be "" while a character is
        still partial; the remainder arrives with the next token)."""
        return self._dec.decode(self._tok.token_bytes(token_id))

    def flush(self) -> str:
        """Drain any dangling partial character (end of stream)."""
        return self._dec.decode(b"", final=True)


class Tokenizer:
    def __init__(self, path: str):
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        config = data.get("config", {})
        self.n_special = int(config.get("default_num_special_tokens", 1000))
        self.special_ids = {int(st["rank"]) for st in data.get("special_tokens", [])
                            if "rank" in st}
        self._vocab = data["vocab"]
        self._cache: dict[int, bytes] = {}
        self.bos = 1
        self.eos = 2
        self.streaming_pad = 32

    @property
    def vocab_size(self) -> int:
        return self.n_special + len(self._vocab)

    def token_bytes(self, token_id: int) -> bytes:
        b = self._cache.get(token_id)
        if b is not None:
            return b
        if (token_id < self.n_special or token_id in self.special_ids
                or token_id - self.n_special >= len(self._vocab)):
            b = b""
        else:
            b = base64.b64decode(self._vocab[token_id - self.n_special]["token_bytes"])
        self._cache[token_id] = b
        return b

    def decode_piece(self, token_id: int) -> str:
        """Single-token decode with lossy UTF-8. For STREAMS use
        stream_decoder() instead — a character split across two tokens
        decodes to U+FFFD here."""
        return self.token_bytes(token_id).decode("utf-8", errors="replace")

    def stream_decoder(self) -> StreamDecoder:
        """Per-stream incremental decoder (UTF-8-correct across tokens)."""
        return StreamDecoder(self)

    def decode(self, token_ids) -> str:
        out = bytearray()
        for t in token_ids:
            out += self.token_bytes(int(t))
        return out.decode("utf-8", errors="replace")

    def is_text(self, token_id: int) -> bool:
        """TEXT classification per stream_classify_token (voxtral.c:533-539):
        text-range id that decodes to a non-empty piece."""
        return token_id >= self.n_special and len(self.token_bytes(token_id)) > 0


def make_test_tokenizer_json(path: str, vocab_size: int = 256) -> None:
    """Write a miniature tekken.json for tests: printable single-byte vocab."""
    vocab = []
    for i in range(vocab_size):
        byte = bytes([32 + (i % 95)])  # printable ASCII
        vocab.append({"rank": i,
                      "token_bytes": base64.b64encode(byte).decode()})
    data = {
        "config": {"default_num_special_tokens": 100},
        "special_tokens": [{"rank": r, "token_str": f"<s{r}>"} for r in range(3)],
        "vocab": vocab,
    }
    with open(path, "w") as f:
        json.dump(data, f)
