"""Llama-3 tiktoken vocab -> reference `.t` tokenizer file.

Equivalent of the reference converter (ref:
converter/convert-tokenizer-llama3.py): the input is the tiktoken text format
(one `base64token rank` pair per line); merge priority is encoded as a
negative-rank score so the engine's greedy highest-score merge reproduces BPE
rank order, and the 256 llama-3 special tokens are appended after the base
vocab (ref: convert-tokenizer-llama3.py:13-79).
"""

from __future__ import annotations

import argparse
import base64

from ..io.tokenizer_file import TokenizerData, write_tokenizer_file

N_SPECIAL = 256
# the reference's (Llama-3.0) special-token name table (ref:
# convert-tokenizer-llama3.py:14-27) — kept identical so produced .t files
# are interchangeable with the reference's published dllama_tokenizer_llama3.t
SPECIAL_TOKENS = [
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>",
    "<|reserved_special_token_2|>",
    "<|reserved_special_token_3|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|reserved_special_token_4|>",
    "<|eot_id|>",
]


def load_tiktoken_vocab(path: str) -> list[bytes]:
    vocab: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            tok = base64.b64decode(token_b64)
            assert int(rank) == len(vocab), "ranks must be dense and ordered"
            vocab.append(tok)
    return vocab


def llama3_to_tokenizer_data(path: str, bos_id: int | None = None,
                             eos_id: int | None = None) -> TokenizerData:
    """bos/eos default to the reference's ids: bos=<|begin_of_text|> (128000),
    eos=<|end_of_text|> (128001) — what a base model emits; instruct chat
    stops on <|eot_id|> because generation stops on the whole
    Tokenizer.stop_token_ids() set, not eos_id alone
    (ref: convert-tokenizer-llama3.py:29-30)."""
    base = load_tiktoken_vocab(path)
    specials = list(SPECIAL_TOKENS)
    specials += [f"<|reserved_special_token_{i}|>"
                 for i in range(5, 5 + N_SPECIAL - len(specials))]
    vocab = base + [s.encode() for s in specials]
    # negative-rank scores: higher-priority merges (lower rank) score higher;
    # specials continue the -rank sequence (ref: convert-tokenizer-llama3.py:52-58)
    scores = [-float(i) for i in range(len(vocab))]
    bos = vocab.index(b"<|begin_of_text|>") if bos_id is None else bos_id
    eos = vocab.index(b"<|end_of_text|>") if eos_id is None else eos_id
    return TokenizerData(vocab=vocab, scores=scores, bos_id=bos, eos_id=eos)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a llama-3 tiktoken vocab to .t")
    ap.add_argument("model", help="tiktoken file (tokenizer.model)")
    ap.add_argument("output")
    ap.add_argument("--bos-id", type=int, default=None,
                    help="override bos id (default: <|begin_of_text|>)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="override eos id (default: <|end_of_text|>; pass the "
                         "<|eot_id|> index for instruct-tuned chat models)")
    args = ap.parse_args(argv)
    data = llama3_to_tokenizer_data(args.model, args.bos_id, args.eos_id)
    write_tokenizer_file(args.output, data)
    print(f"✅ wrote {args.output}: vocab={data.vocab_size} "
          f"bos={data.bos_id} eos={data.eos_id}")


if __name__ == "__main__":
    main()
