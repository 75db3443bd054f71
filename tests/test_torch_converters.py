"""The port's converters held against the JAX package's, on the synthetic
inputs of tests/test_converters.py: a tiny HF Llama and Mixtral saved as
safetensors, a 2-shard Meta consolidated.*.pth, Grok-1 torch dumps (3 files
and the 19-file layout), a sentencepiece .model and a tiktoken vocab. Each
port converter writes a file byte for byte equal to the JAX converter's;
the converted Llama `.m` loaded by the port gives the JAX engine's f32
logits (within 1e-5) and greedy tokens.
"""

import base64
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.converters import grok1 as jax_grok1
from distributed_llama_tpu.converters import hf as jax_hf
from distributed_llama_tpu.converters import meta_llama as jax_meta
from distributed_llama_tpu.converters import tokenizer_llama3 as jax_llama3
from distributed_llama_tpu.converters import tokenizer_spm as jax_spm
from distributed_llama_tpu.io.model_file import read_model as jax_read_model
from distributed_llama_tpu.io.tokenizer_file import write_tokenizer_file as jax_write_tok
from distributed_llama_tpu.models.params import load_params as jax_load_params
from distributed_llama_tpu.quants.types import FloatType as JaxFloatType
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu_torch.converters import grok1, hf, meta_llama
from distributed_llama_tpu_torch.converters import tokenizer_llama3, tokenizer_spm
from distributed_llama_tpu_torch.io.model_file import model_tensor_plan, read_model
from distributed_llama_tpu_torch.io.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.models.params import load_params
from distributed_llama_tpu_torch.models.spec import ArchType, HiddenAct, ModelSpec
from distributed_llama_tpu_torch.quants.types import FloatType
from distributed_llama_tpu_torch.runtime.engine import Engine

FTYPES = ("F32", "Q40")


def _random_dense(spec, seed):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape, dtype=np.float32) * 0.05
            for name, shape, _ in model_tensor_plan(spec)}


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got, want = fa.read(), fb.read()
    assert len(got) == len(want) and got == want


@pytest.fixture(scope="module")
def hf_llama(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    config = transformers.LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(config).eval().float()
    d = tmp_path_factory.mktemp("hf_llama")
    model.save_pretrained(str(d / "hf"), safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def hf_mixtral(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    config = transformers.MixtralConfig(
        hidden_size=64, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        num_local_experts=4, num_experts_per_tok=2, tie_word_embeddings=False)
    torch.manual_seed(1)
    model = transformers.MixtralForCausalLM(config).eval().float()
    d = tmp_path_factory.mktemp("hf_mixtral")
    model.save_pretrained(str(d / "hf"), safe_serialization=True)
    return d


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("which", ["llama", "mixtral"])
def test_hf_converter_writes_the_jax_converters_bytes(which, ftype, hf_llama,
                                                      hf_mixtral, tmp_path):
    d = hf_llama if which == "llama" else hf_mixtral
    mine, theirs = str(tmp_path / "port.m"), str(tmp_path / "jax.m")
    spec = hf.convert_hf(str(d / "hf"), mine, FloatType[ftype], max_seq_len=48,
                         progress=False)
    jax_hf.convert_hf(str(d / "hf"), theirs, JaxFloatType[ftype], max_seq_len=48,
                      progress=False)
    _same_bytes(mine, theirs)
    assert spec.seq_len == 48
    assert (spec.arch == ArchType.MIXTRAL) == (which == "mixtral")


def test_permute_rotary_and_spec_from_config_match_jax():
    w = np.random.default_rng(3).standard_normal((64, 12)).astype(np.float32)
    for heads in (1, 2, 4, 8):
        np.testing.assert_array_equal(hf.permute_rotary(w, heads),
                                      jax_hf.permute_rotary(w, heads))
    cfg = {"model_type": "mistral", "hidden_size": 64, "intermediate_size": 96,
           "num_hidden_layers": 2, "num_attention_heads": 4, "vocab_size": 100,
           "hidden_act": "gelu_new", "rope_theta": 5e5}
    mine = hf.spec_from_config(cfg, FloatType.Q40, 512)
    theirs = jax_hf.spec_from_config(cfg, JaxFloatType.Q40, 512)
    assert (mine.arch.value, mine.hidden_act.value, mine.n_kv_heads, mine.seq_len,
            mine.rope_theta) == (theirs.arch.value, theirs.hidden_act.value,
                                 theirs.n_kv_heads, theirs.seq_len, theirs.rope_theta)
    for bad in ({"model_type": "gpt2"},
                dict(cfg, rope_scaling={"rope_type": "linear", "factor": 2.0})):
        with pytest.raises(ValueError):
            hf.spec_from_config(dict(cfg, **bad), FloatType.F32)


def _meta_folder(tmp_path, spec, dense):
    meta_names = {"tok_emb": "tok_embeddings.weight", "rms_final": "norm.weight",
                  "wcls": "output.weight"}
    table = {"wq": "attention.wq", "wk": "attention.wk", "wv": "attention.wv",
             "wo": "attention.wo", "w1": "feed_forward.w1", "w2": "feed_forward.w2",
             "w3": "feed_forward.w3", "rms_att": "attention_norm",
             "rms_ffn": "ffn_norm"}

    def meta_name(plan):
        if plan in meta_names:
            return meta_names[plan]
        _, l, rest = plan.split(".", 2)
        return f"layers.{l}.{table[rest]}.weight"

    shards = [dict(), dict()]
    for name, x in dense.items():
        if x.ndim == 1:
            for s in shards:
                s[meta_name(name)] = torch.tensor(x)
        else:
            ax = 1 if name.split(".")[-1] in ("tok_emb", "wo", "w2") else 0
            for i, part in enumerate(np.array_split(x, 2, axis=ax)):
                shards[i][meta_name(name)] = torch.tensor(part.copy())
    folder = tmp_path / "meta"
    folder.mkdir()
    for i, s in enumerate(shards):
        torch.save(s, str(folder / f"consolidated.{i:02d}.pth"))
    with open(folder / "params.json", "w") as f:
        json.dump({"dim": spec.dim, "n_layers": spec.n_layers, "n_heads": spec.n_heads,
                   "n_kv_heads": spec.n_kv_heads, "vocab_size": spec.vocab_size,
                   "max_seq_len": spec.seq_len, "rope_theta": 10000.0}, f)
    return folder


META_SPEC = ModelSpec(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2,
                      n_heads=4, n_kv_heads=2, vocab_size=96, seq_len=32,
                      hidden_act=HiddenAct.SILU)


@pytest.mark.parametrize("ftype", FTYPES)
def test_meta_converter_writes_the_jax_converters_bytes(ftype, tmp_path):
    dense = _random_dense(META_SPEC, seed=21)
    folder = _meta_folder(tmp_path, META_SPEC, dense)
    mine, theirs = str(tmp_path / "port.m"), str(tmp_path / "jax.m")
    spec = meta_llama.convert_meta(str(folder), mine, FloatType[ftype], progress=False)
    jax_meta.convert_meta(str(folder), theirs, JaxFloatType[ftype], progress=False)
    _same_bytes(mine, theirs)
    assert spec.hidden_dim == 128 and spec.seq_len == 32
    if ftype == "F32":
        _, tensors = read_model(mine)
        for name, x in dense.items():
            np.testing.assert_array_equal(tensors[name].to_f32(), x, err_msg=name)


def _grok_folder(tmp_path, spec, dense, n_files, sequential):
    names = list(dense)
    shards = [dict() for _ in range(n_files)]
    per = max(1, len(names) // n_files)
    for i, name in enumerate(names):
        k = min(i // per, n_files - 1) if sequential else i % n_files
        shards[k][grok1._grok_name(name)] = torch.tensor(dense[name])
    folder = tmp_path / f"grok{n_files}"
    folder.mkdir()
    for i, s in enumerate(shards):
        torch.save(s, str(folder / f"pytorch_model-{i + 1:05d}-of-{n_files:05d}.bin"))
    return folder


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("layout", ["3 files round robin", "19 files in order"])
def test_grok1_converter_writes_the_jax_converters_bytes(layout, ftype, tmp_path):
    n_files, n_layers = (3, 2) if layout.startswith("3") else (19, 4)
    spec = ModelSpec(arch=ArchType.GROK1, dim=64, hidden_dim=96, n_layers=n_layers,
                     n_heads=4, n_kv_heads=2, n_experts=4, n_active_experts=2,
                     vocab_size=96, seq_len=32, hidden_act=HiddenAct.GELU,
                     weights_float_type=FloatType[ftype])
    dense = _random_dense(spec, seed=22 + n_files)
    folder = _grok_folder(tmp_path, spec, dense, n_files, n_files == 19)
    jspec = jax_grok1.ModelSpec(**{**spec.__dict__, "arch": jax_grok1.ArchType.GROK1,
                                   "hidden_act": jax_grok1.HiddenAct.GELU,
                                   "weights_float_type": JaxFloatType[ftype]})
    assert grok1._grok_name("layers.1.experts.2.down") == \
        jax_grok1._grok_name("layers.1.experts.2.down")
    mine, theirs = str(tmp_path / "port.m"), str(tmp_path / "jax.m")
    grok1.convert_grok1(str(folder), mine, FloatType[ftype], progress=False, spec=spec,
                        n_files=n_files)
    jax_grok1.convert_grok1(str(folder), theirs, JaxFloatType[ftype], progress=False,
                            spec=jspec, n_files=n_files)
    _same_bytes(mine, theirs)


def _encode_varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _spm_piece(piece: bytes, score: float, ptype: int | None = None) -> bytes:
    body = bytes([0x0A]) + _encode_varint(len(piece)) + piece
    body += bytes([0x15]) + struct.pack("<f", score)
    if ptype is not None:
        body += bytes([0x18]) + _encode_varint(ptype)
    return bytes([0x0A]) + _encode_varint(len(body)) + body


@pytest.mark.parametrize("ids", [(1, 2), (0, 4)])
def test_spm_tokenizer_converter_writes_the_jax_converters_bytes(ids, tmp_path):
    rng = np.random.default_rng(4)
    pieces = [(b"<unk>", 0.0, 2), (b"<s>", 0.0, 3), (b"</s>", 0.0, 3),
              ("▁hi".encode(), -1.5, None), (b"x", -2.0, None), (b"<0x0A>", 0.0, 6)]
    pieces += [(("▁" + "".join(chr(97 + c) for c in rng.integers(0, 26, 4))).encode(),
                float(-rng.random() * 9), None) for _ in range(40)]
    path = tmp_path / "tok.model"
    path.write_bytes(b"".join(_spm_piece(p, s, t) for p, s, t in pieces))
    assert tokenizer_spm.parse_spm_model(str(path)) == jax_spm.parse_spm_model(str(path))
    mine, theirs = tmp_path / "port.t", tmp_path / "jax.t"
    write_tokenizer_file(str(mine), tokenizer_spm.spm_to_tokenizer_data(str(path), *ids))
    jax_write_tok(str(theirs), jax_spm.spm_to_tokenizer_data(str(path), *ids))
    _same_bytes(mine, theirs)
    out = tmp_path / "main.t"
    tokenizer_spm.main([str(path), str(out), "--bos-id", str(ids[0]),
                        "--eos-id", str(ids[1])])
    _same_bytes(out, theirs)


@pytest.mark.parametrize("eos", [None, 9])
def test_llama3_tokenizer_converter_writes_the_jax_converters_bytes(eos, tmp_path):
    rng = np.random.default_rng(5)
    toks = [b"a", b"b", b"ab", b" the"] + [bytes(rng.integers(0, 256, 3).tolist())
                                           for _ in range(60)]
    path = tmp_path / "tokenizer.model"
    with open(path, "wb") as f:
        for i, t in enumerate(toks):
            f.write(base64.b64encode(t) + b" " + str(i).encode() + b"\n")
    eos_id = None if eos is None else len(toks) + eos
    mine, theirs = tmp_path / "port.t", tmp_path / "jax.t"
    write_tokenizer_file(str(mine), tokenizer_llama3.llama3_to_tokenizer_data(
        str(path), eos_id=eos_id))
    jax_write_tok(str(theirs), jax_llama3.llama3_to_tokenizer_data(str(path),
                                                                   eos_id=eos_id))
    _same_bytes(mine, theirs)
    out = tmp_path / "main.t"
    tokenizer_llama3.main([str(path), str(out)] + ([] if eos is None else
                                                   ["--eos-id", str(eos_id)]))
    _same_bytes(out, theirs)


def _greedy(engine, fetch, prompt, n):
    engine.reset()
    lg = fetch(engine.prefill(list(prompt)))[0]
    first, toks = lg, []
    for _ in range(n):
        toks.append(int(np.argmax(lg)))
        lg = fetch(engine.step(np.asarray([[toks[-1]]], np.int32), engine.pos))[0]
    return first, toks


def test_converted_llama_runs_in_the_port_as_in_the_jax_engine(hf_llama, tmp_path):
    """The HF Llama converted by the port (f32): the port engine on the
    file gives the JAX engine's logits on the same file within 1e-5 and the
    same greedy tokens; the main() entry writes the same bytes."""
    mpath = str(tmp_path / "model.m")
    assert hf.main([str(hf_llama / "hf"), mpath, "--weights-float-type", "f32"]) is None
    spec, tensors = read_model(mpath)
    eng = Engine(spec, load_params(spec, tensors, mode="dense", dtype=torch.float32,
                                   device="cpu"),
                 device="cpu", compute_dtype=torch.float32, cache_dtype=torch.float32)
    jspec, jtensors = jax_read_model(mpath)
    jeng = JaxEngine(jspec, jax_load_params(jspec, jtensors, mode="dense",
                                            dtype=jnp.float32),
                     compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    prompt = [1, 17, 93, 5, 64, 22]
    got, got_toks = _greedy(eng, eng.fetch_logits, prompt, 6)
    want, want_toks = _greedy(jeng, jeng.fetch_logits, prompt, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got_toks == want_toks
