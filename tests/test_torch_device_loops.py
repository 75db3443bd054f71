"""The port's on-device decode loops held against the JAX engine's on the
tiny fixture, batch 1, all f32: Engine.decode_greedy_device (JAX
runtime/engine.py:2215) and Engine.generate_device (:1990) give the JAX
engine's tokens, pos and last_device_steps, mirroring the JAX tests at
tests/test_device_sampler.py:162-231; the port CLI's --device-sampling
prints the JAX CLI's tokens. The JAX engine runs its Pallas kernels in
interpret mode; the port engine runs on the CPU, where its steps run
eagerly (on the card they replay captured CUDA graphs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.io.model_file import read_model
from distributed_llama_tpu.models.params import load_params
from distributed_llama_tpu.models.spec import ArchType
from distributed_llama_tpu.runtime.engine import Engine as JaxEngine
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.models.convert import params_from_jax
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler

PROMPT = [1, 72, 101, 108, 108, 111, 44]


def _engines(tmp_path_factory, arch):
    moe = dict(arch=ArchType.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, _ = write_fixture(tmp_path_factory.mktemp("fx"), seed=61,
                             **(moe if arch == "MIXTRAL" else {}))
    spec, tensors = read_model(mpath)
    jparams = load_params(spec, tensors, mode="q40", dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jeng = JaxEngine(spec, jparams, compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32, pallas_interpret=True, prefill_chunk=4)
    eng = Engine(spec, params_from_jax(np_params, spec, "cpu"), device="cpu",
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 prefill_chunk=4)
    return spec, jeng, eng


@pytest.fixture(scope="module", params=["LLAMA", "MIXTRAL"])
def engines(request, tmp_path_factory):
    return _engines(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    """One arch for the loop's edges: the JAX loop compiles per budget and
    config, in interpret mode, for seconds each."""
    return _engines(tmp_path_factory, "LLAMA")


@pytest.mark.parametrize("prefix", [0, len(PROMPT)])
def test_decode_greedy_device_matches_jax(engines, prefix):
    """From pos 0 and from after a prefill (the loop zeroes the cache and
    keeps pos, as the JAX loop's fresh cache does): the same tokens, in the
    same (n_tokens, batch) shape, and the same pos."""
    _, jeng, eng = engines
    jeng.reset()
    eng.reset()
    jeng.prefill(PROMPT[:prefix]) if prefix else None
    eng.prefill(PROMPT[:prefix]) if prefix else None
    want, _ = jeng.decode_greedy_device(5, 12)
    got, seconds = eng.decode_greedy_device(5, 12)
    assert got.shape == (12, 1) and got.dtype == np.int32 and seconds >= 0
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.pos == jeng.pos == prefix + 12
    assert not eng.graphs          # the CPU engine captures nothing


def test_decode_greedy_device_equals_host_generate(engines):
    """From pos 0 on a zeroed cache, the loop's tokens are generate()'s with
    a greedy host sampler from the same first token."""
    spec, _, eng = engines
    eng.reset()
    want = eng.generate([5], 10, Sampler(spec.vocab_size, 0.0, 0.9, 1)).tokens
    eng.reset()
    got, _ = eng.decode_greedy_device(5, 10)
    assert got.ravel().tolist() == want


def test_decode_greedy_device_refuses_a_run_past_the_cache(engines):
    _, _, eng = engines
    eng.reset()
    eng.pos = eng.seq_len - 3
    with pytest.raises(ValueError, match="context overflow"):
        eng.decode_greedy_device(5, 4)
    eng.reset()


@pytest.mark.parametrize("temperature,topp,seed", [(0.0, 0.9, 3), (0.8, 0.9, 1234)])
def test_generate_device_matches_jax(engines, temperature, topp, seed):
    spec, jeng, eng = engines
    jeng.reset()
    eng.reset()
    want = jeng.generate_device(PROMPT, 16, temperature=temperature, topp=topp, seed=seed)
    got = eng.generate_device(PROMPT, 16, temperature=temperature, topp=topp, seed=seed)
    assert got == want
    assert eng.pos == jeng.pos == len(PROMPT) + 15
    assert eng.last_device_steps == jeng.last_device_steps == 16
    # and the host loop with the same seed
    eng.reset()
    assert eng.generate(PROMPT, 16, Sampler(spec.vocab_size, temperature, topp,
                                            seed)).tokens == got


def test_generate_device_multinomial_matches_jax(llama):
    """topp 0: the plain multinomial branch."""
    _, jeng, eng = llama
    jeng.reset()
    eng.reset()
    want = jeng.generate_device(PROMPT, 16, temperature=0.9, topp=0.0, seed=11)
    got = eng.generate_device(PROMPT, 16, temperature=0.9, topp=0.0, seed=11)
    assert got == want and eng.pos == jeng.pos


@pytest.mark.parametrize("temperature,topp,seed", [(0.7, 0.9, 3), (1.0, 0.5, 8),
                                                   (0.9, 1.0, 21), (0.6, 0.95, 99)])
def test_generate_device_equals_host_generate(engines, temperature, topp, seed):
    """The port's device loop against its own host loop, same seed."""
    spec, _, eng = engines
    eng.reset()
    want = eng.generate(PROMPT, 12, Sampler(spec.vocab_size, temperature, topp, seed))
    eng.reset()
    got = eng.generate_device(PROMPT, 12, temperature=temperature, topp=topp, seed=seed)
    assert got == want.tokens and eng.last_device_steps == 12


def test_generate_device_eos_truncation_and_continuation(llama):
    """A stop token ends the run (included), the forward of the last token
    never runs, and a continued session matches an unbroken run."""
    _, jeng, eng = llama
    eng.reset()
    probe = eng.generate_device(PROMPT, 6, temperature=0.0, topp=0.9, seed=1)
    eos = probe[2]
    eng.reset()
    jeng.reset()
    out = eng.generate_device(PROMPT, 6, temperature=0.0, topp=0.9, seed=1, eos_id=eos)
    want = jeng.generate_device(PROMPT, 6, temperature=0.0, topp=0.9, seed=1, eos_id=eos)
    assert out == want == probe[:probe.index(eos) + 1]
    assert eng.pos == jeng.pos == len(PROMPT) + len(out) - 1
    assert eng.last_device_steps == jeng.last_device_steps == len(out)
    # nothing was written at the stop token's position
    assert not eng.cache.k[0][0, :, eng.pos].any()
    cont = eng.generate_device([probe[2], probe[3]], 2, temperature=0.0, topp=0.9, seed=1)
    eng.reset()
    full = eng.generate_device(PROMPT + probe[:4], 2, temperature=0.0, topp=0.9, seed=1)
    assert cont == full


def test_generate_device_early_exit_and_budget_edges(llama):
    """Budget 64 with the probe's third token as the stop token: the run
    ends at its first appearance, one forward fewer than tokens; a budget
    of 0 emits nothing; a prompt at the context edge emits one
    token and steps none, as generate() does."""
    spec, _, eng = llama
    eng.reset()
    probe = eng.generate_device(PROMPT, 6, temperature=0.0, topp=0.9, seed=1)
    eng.reset()
    out = eng.generate_device(PROMPT, 64, temperature=0.0, topp=0.9, seed=1, eos_id=probe[2])
    assert out == probe[:probe.index(probe[2]) + 1]
    assert eng.last_device_steps == len(out) and eng.pos == len(PROMPT) + len(out) - 1
    eng.reset()
    assert eng.generate_device(PROMPT, 0, temperature=0.0, topp=0.9, seed=1) == []
    assert eng.last_device_steps == 0 and eng.pos == len(PROMPT)
    edge = [1] * spec.seq_len
    eng.reset()
    want = eng.generate(edge, 5, Sampler(spec.vocab_size, 0.8, 0.9, 2)).tokens
    eng.reset()
    got = eng.generate_device(edge, 5, temperature=0.8, topp=0.9, seed=2)
    assert got == want and len(got) == 1 and eng.pos == spec.seq_len


def test_generate_device_vocab_size_truncates(llama):
    spec, _, eng = llama
    eng.reset()
    want = eng.generate(PROMPT, 8, Sampler(40, 0.9, 0.0, 5)).tokens
    eng.reset()
    got = eng.generate_device(PROMPT, 8, temperature=0.9, topp=0.0, seed=5, vocab_size=40)
    assert got == want and max(got) < 40


@pytest.mark.parametrize("arch,temperature", [("LLAMA", "0.7"), ("MIXTRAL", "0")])
def test_cli_device_sampling_prints_jax_cli_tokens(tmp_path, capsys, arch, temperature):
    moe = dict(arch=ArchType.MIXTRAL, n_experts=4, n_active_experts=2)
    mpath, tpath = write_fixture(tmp_path, seed=23, **(moe if arch == "MIXTRAL" else {}))
    common = ["generate", "--model", mpath, "--tokenizer", tpath, "--prompt", "ab",
              "--steps", "12", "--seed", "7", "--temperature", temperature,
              "--compute-dtype", "f32", "--cache-dtype", "f32",
              "--buffer-float-type", "f32", "--device-sampling"]
    jax_dllama.main(common)
    want = capsys.readouterr().out.splitlines()
    dllama.main(common + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()

    def text(lines):
        return lines[next(i for i, l in enumerate(lines) if l.startswith("💡")):]

    assert text(got) == text(want)


def test_cli_inference_device_sampling_reports_the_loop(tmp_path, capsys):
    mpath, tpath = write_fixture(tmp_path, seed=2)
    dllama.main(["inference", "--model", mpath, "--tokenizer", tpath, "--prompt", "ab",
                 "--steps", "4", "--seed", "7", "--temperature", "0",
                 "--device-sampling", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Generated tokens:    4 (on-device loop, 4 device steps)" in out
    assert "Wall time:" in out and "includes the prefill" in out
    assert "🔶 G" not in out
