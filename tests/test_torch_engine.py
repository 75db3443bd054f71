"""The port's Engine and CLI held against the JAX package's on the tiny
fixture, all f32: the same prompt through chunked prefill (several chunks)
and decode must give identical greedy tokens and identical seeded sampled
tokens; the port CLI must print the JAX CLI's tokens. The JAX engine runs
its Pallas kernels in interpret mode; the port runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.io.model_file import read_model
from distributed_llama_tpu.models.params import load_params
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler

PROMPT = [1, 72, 101, 108, 108, 111, 44, 32, 119, 111, 114, 108, 100]
STEPS = 20


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    d = tmp_path_factory.mktemp("fx")
    mpath, _ = write_fixture(d, seed=19)
    spec, tensors = read_model(mpath)
    jparams = load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jeng = JaxEngine(spec, jparams, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32, pallas_interpret=True,
                     prefill_chunk=5)
    eng = Engine(spec, params_from_jax(np_params, spec, "cpu"), device="cpu",
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 prefill_chunk=5)
    return spec, jeng, eng


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 1234)])
def test_generate_matches_jax_engine(engines, temperature, seed):
    spec, jeng, eng = engines
    jeng.reset()
    eng.reset()
    want = jeng.generate(PROMPT, STEPS, JaxSampler(
        spec.vocab_size, temperature, 0.9, seed, backend="python")).tokens
    got = eng.generate(PROMPT, STEPS, Sampler(
        spec.vocab_size, temperature, 0.9, seed)).tokens
    assert len(got) == STEPS
    assert got == want
    assert eng.pos == jeng.pos == len(PROMPT) + STEPS - 1


def test_prefill_chunks_match_one_segment(engines):
    """Prefill in chunks of 5 gives the logits of the unchunked prompt."""
    spec, _, eng = engines
    eng.reset()
    chunked = eng.fetch_logits(eng.prefill(PROMPT))
    eng.reset()
    whole = eng.fetch_logits(eng.step(np.asarray([PROMPT], np.int32), 0))
    np.testing.assert_allclose(chunked, whole, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["LLAMA", "MIXTRAL"])
@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_cli_generate_prints_jax_cli_tokens(tmp_path, capsys, temperature,
                                            arch):
    from distributed_llama_tpu.models.spec import ArchType

    moe = dict(arch=ArchType.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, tpath = write_fixture(tmp_path, seed=44,
                                 **(moe if arch == "MIXTRAL" else {}))
    common = ["generate", "--model", mpath, "--tokenizer", tpath,
              "--prompt", "hello world", "--steps", "16", "--seed", "9",
              "--temperature", temperature, "--compute-dtype", "f32",
              "--cache-dtype", "f32"]
    jax_dllama.main(common + ["--buffer-float-type", "f32"])
    want = capsys.readouterr().out.splitlines()
    dllama.main(common + ["--buffer-float-type", "f32", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()

    def text(lines):
        i = next(k for k, l in enumerate(lines) if l.startswith("💡"))
        return lines[i:]

    assert text(got) == text(want)


def test_cli_inference_prints_benchmark_lines(tmp_path, capsys):
    mpath, tpath = write_fixture(tmp_path, seed=2)
    dllama.main(["inference", "--model", mpath, "--tokenizer", tpath,
                 "--prompt", "ab", "--steps", "4", "--seed", "7",
                 "--temperature", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Generated tokens:    4" in out
    assert out.count("🔶 G") == 4
    assert "Avg generation time:" in out


@pytest.mark.parametrize("flags,needle", [
    (["chat"], "mode 'chat'"),
    (["api", "--prefix-cache"], "--prefix-cache"),
    (["worker"], "mode 'worker'"),
    (["generate", "--tp", "2"], "--tp 2"),
    (["generate", "--pp", "2"], "--pp 2"),
    (["generate", "--dp", "2"], "--dp 2"),
    (["generate", "--ep", "2"], "--ep 2"),
    (["generate", "--nnodes", "2"], "--nnodes"),
])
def test_cli_refuses_unported_flags(flags, needle):
    with pytest.raises(SystemExit) as e:
        dllama.main(flags + ["--model", "x.m", "--tokenizer", "x.t"])
    assert needle in str(e.value) and "not ported" in str(e.value)
