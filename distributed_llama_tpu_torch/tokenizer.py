"""llama2.c-style BPE tokenizer.

Behavioral port of the reference tokenizer (ref: src/tokenizer.cpp:109-229):
UTF-8 codepoint scan, byte-fallback at +3 offset, then greedy highest-score
pair merging. Decode strips a leading space after BOS and expands `<0xXX>`
raw-byte pieces (ref: src/tokenizer.cpp:89-100).

This is the pure-Python backend of the JAX package's tokenizer; its native
C++ twin is not part of the port yet.
"""

from __future__ import annotations

from .io.tokenizer_file import TokenizerData, read_tokenizer_file


class Tokenizer:
    def __init__(self, data: TokenizerData):
        self.data = data
        self.vocab = data.vocab
        self.scores = data.scores
        self.bos_id = data.bos_id
        self.eos_id = data.eos_id
        self._index: dict[bytes, int] = {}
        for i, tok in enumerate(self.vocab):
            # first occurrence wins, like bsearch over a stable-sorted vocab
            if tok not in self._index:
                self._index[tok] = i

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        return cls(read_tokenizer_file(path))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # end-of-turn pieces emitted by instruct-tuned models whose header eos_id
    # is the base-model eos (e.g. llama-3: eos=<|end_of_text|> while chat
    # turns end with <|eot_id|>/<|eom_id|>)
    CHAT_STOP_PIECES = (b"<|eot_id|>", b"<|eom_id|>")

    def stop_token_ids(self) -> set[int]:
        """eos_id plus any end-of-turn marker tokens present in the vocab —
        the id set generation should stop on."""
        ids = {self.eos_id}
        for piece in self.CHAT_STOP_PIECES:
            tid = self._index.get(piece)
            if tid is not None:
                ids.add(tid)
        return ids

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> list[int]:
        tokens: list[int] = []
        if add_bos:
            tokens.append(self.bos_id)

        raw = text.encode("utf-8")
        if raw:
            # dummy space prefix (ref: src/tokenizer.cpp:140-144)
            space = self._index.get(b" ")
            if space is not None:
                tokens.append(space)

        # codepoint scan with byte fallback (ref: src/tokenizer.cpp:155-192)
        i = 0
        while i < len(raw):
            j = i + 1
            # gather continuation bytes, capped at 4 total like the reference
            while j < len(raw) and (raw[j] & 0xC0) == 0x80 and (j - i) < 4:
                j += 1
            piece = raw[i:j]
            tid = self._index.get(piece)
            if tid is not None:
                tokens.append(tid)
            else:
                # byte fallback, +3 offset; clamp to <unk> (0) if the vocab
                # has no byte tokens (the reference indexes unchecked)
                tokens.extend(b + 3 if b + 3 < len(self.vocab) else 0
                              for b in piece)
            i = j

        # greedy merge of the best-scoring adjacent pair (ref: src/tokenizer.cpp:195-223)
        while True:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for k in range(len(tokens) - 1):
                merged = self.vocab[tokens[k]] + self.vocab[tokens[k + 1]]
                mid = self._index.get(merged)
                if mid is not None and self.scores[mid] > best_score:
                    best_score = self.scores[mid]
                    best_id = mid
                    best_idx = k
            if best_idx == -1:
                break
            tokens[best_idx:best_idx + 2] = [best_id]

        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        piece = self.vocab[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            piece = piece[1:]
        # raw-byte pieces look like b'<0xAB>' (ref: src/tokenizer.cpp:93-98)
        if len(piece) == 6 and piece.startswith(b"<0x") and piece.endswith(b">"):
            try:
                return bytes([int(piece[3:5], 16)])
            except ValueError:
                pass
        return piece

    def decode(self, tokens: list[int]) -> str:
        out = bytearray()
        prev = self.bos_id if tokens and tokens[0] == self.bos_id else -1
        for t in tokens:
            if t == self.bos_id:
                prev = t
                continue
            out += self.decode_piece(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")
