"""`.t` tokenizer-file format.

Byte-compatible with the reference (ref: src/tokenizer.hpp:16-23,
tokenizer.cpp:38-80): a 24-byte header {magic 0x567123, vocabSize,
maxTokenLength, bosId, eosId, padId} followed by, per token, an f32 score,
an i32 byte-length and the raw token bytes.
"""

from __future__ import annotations

import dataclasses
import struct

TOKENIZER_MAGIC = 0x567123


@dataclasses.dataclass
class TokenizerData:
    vocab: list[bytes]
    scores: list[float]
    bos_id: int
    eos_id: int
    pad_id: int = -1

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def max_token_length(self) -> int:
        return max((len(t) for t in self.vocab), default=0)


def read_tokenizer_file(path: str) -> TokenizerData:
    with open(path, "rb") as f:
        magic, vocab_size, _max_len, bos_id, eos_id, pad_id = struct.unpack("<IIIiii", f.read(24))
        if magic != TOKENIZER_MAGIC:
            raise ValueError(f"invalid tokenizer file magic {magic:#x}")
        vocab: list[bytes] = []
        scores: list[float] = []
        for _ in range(vocab_size):
            score, length = struct.unpack("<fi", f.read(8))
            vocab.append(f.read(length))
            scores.append(score)
    return TokenizerData(vocab=vocab, scores=scores, bos_id=bos_id, eos_id=eos_id, pad_id=pad_id)


def write_tokenizer_file(path: str, data: TokenizerData) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(
            "<IIIiii", TOKENIZER_MAGIC, data.vocab_size, data.max_token_length,
            data.bos_id, data.eos_id, data.pad_id,
        ))
        for tok, score in zip(data.vocab, data.scores):
            f.write(struct.pack("<fi", score, len(tok)))
            f.write(tok)
