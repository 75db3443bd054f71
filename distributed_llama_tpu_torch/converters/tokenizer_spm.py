"""SentencePiece `.model` -> reference `.t` tokenizer file.

Equivalent of the reference converter (ref:
converter/convert-tokenizer-sentencepiece.py): vocab pieces + scores with the
llama2.c conventions — SPM's meta symbol U+2581 becomes a leading space and
`<0xXX>` byte pieces are kept verbatim.

The sentencepiece package is not available in this image, so the ModelProto
is read with a minimal protobuf wire-format parser (the file is just
`repeated SentencePiece pieces = 1` where SentencePiece has
`piece = 1 (string), score = 2 (float), type = 3 (enum)` — see the public
sentencepiece_model.proto).
"""

from __future__ import annotations

import argparse
import struct

from ..io.tokenizer_file import TokenizerData, write_tokenizer_file

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE, UNUSED = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:          # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:        # 64-bit
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:        # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:        # 32-bit
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_spm_model(path: str) -> list[tuple[bytes, float, int]]:
    """-> [(piece_bytes, score, type)] in vocab order."""
    with open(path, "rb") as f:
        raw = f.read()
    pieces: list[tuple[bytes, float, int]] = []
    for field, wire, val in _fields(raw):
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            piece = b""
            score = 0.0
            ptype = NORMAL
            for pf, pw, pv in _fields(val):
                if pf == 1:
                    piece = pv
                elif pf == 2:
                    score = struct.unpack("<f", pv)[0]
                elif pf == 3:
                    ptype = pv
            pieces.append((piece, score, ptype))
    if not pieces:
        raise ValueError(f"{path}: no sentencepiece pieces found")
    return pieces


def spm_to_tokenizer_data(path: str, bos_id: int = 1, eos_id: int = 2) -> TokenizerData:
    pieces = parse_spm_model(path)
    vocab: list[bytes] = []
    scores: list[float] = []
    for i, (piece, score, ptype) in enumerate(pieces):
        text = piece.decode("utf-8", errors="replace")
        # bos/eos pieces are rewritten to the llama2.c display convention the
        # reference exporter uses, keeping .t files byte-compatible with its
        # output (ref: convert-tokenizer-sentencepiece.py:42-45)
        if i == bos_id:
            text = "\n<s>\n"
        elif i == eos_id:
            text = "\n</s>\n"
        # SPM word-boundary marker U+2581 -> leading space (llama2.c convention)
        text = text.replace("▁", " ")
        vocab.append(text.encode("utf-8"))
        scores.append(score)
    return TokenizerData(vocab=vocab, scores=scores, bos_id=bos_id, eos_id=eos_id)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a sentencepiece .model to .t")
    ap.add_argument("model")
    ap.add_argument("output")
    ap.add_argument("--bos-id", type=int, default=1)
    ap.add_argument("--eos-id", type=int, default=2)
    args = ap.parse_args(argv)
    data = spm_to_tokenizer_data(args.model, args.bos_id, args.eos_id)
    write_tokenizer_file(args.output, data)
    print(f"✅ wrote {args.output}: vocab={data.vocab_size} "
          f"bos={data.bos_id} eos={data.eos_id}")


if __name__ == "__main__":
    main()
