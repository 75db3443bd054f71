"""The data axis of the port (Engine(mesh=) with dp ranks, dllama --dp)
held against the JAX package on the CPU, over gloo ranks
(parallel/launch.RankPool):

  * --dp 2 greedy rows equal generate_batch on one device (the port's and
    the JAX engine's), with one row a rank and two;
  * sampled rows at temperature 0.8 equal the JAX generate_batch stream,
    whose rows draw their coins from one shared sampler in row order;
  * a dp x tp mesh (2 x 2) gives the JAX (dp 2, tp 2) engine's rows,
    greedy and sampled, with Q80 activations and collectives;
  * a batch that dp does not divide runs replicated on every dp group;
  * the device loops (decode_greedy_device, generate_device) over tp ranks
    give one device's tokens, and generate_batch_device over dp ranks (row
    i on its stream seed + i) one device's rows;
  * `dllama generate --dp 2` prints the JAX CLI's text (with
    --device-sampling too), `inference` counts every row.
"""

import numpy as np
import pytest

from distributed_llama_tpu.apps import dllama as jax_dllama
from distributed_llama_tpu.sampler import Sampler as JaxSampler
from distributed_llama_tpu.testing import write_fixture
from distributed_llama_tpu_torch.apps import dllama
from distributed_llama_tpu_torch.parallel.launch import RankPool
from distributed_llama_tpu_torch.runtime.engine import Engine
from distributed_llama_tpu_torch.sampler import Sampler
from torch_mesh_cases import ENGINE, F32, Case

PROMPTS = [[1, 5, 9], [2, 7], [3, 3, 3, 3, 40, 41], [8]]


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device_type="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def llama():
    return Case("LLAMA", "q40", seed=21)


def _batch(pool, case, tp, dp, prompts, n, temperature, **kw):
    v = case.pspec.vocab_size
    res = pool.run(ENGINE, tp, dp, case.blob,
                   dict(F32, batch=len(prompts), **kw),
                   [("generate_batch",
                     (prompts, n, Sampler(v, temperature, 0.9, 5)), {})])
    for r in res[1:]:            # every rank holds every row's tokens
        assert r["results"][0] == res[0]["results"][0]
    return res[0]["results"][0]


def _jax_batch(case, prompts, n, temperature, tp=1, dp=1, **kw):
    eng = case.jax_engine(tp=tp, dp=dp, batch=len(prompts), **kw)
    return eng.generate_batch(prompts, n, JaxSampler(
        case.spec.vocab_size, temperature, 0.9, 5, backend="python"))


@pytest.mark.parametrize("rows", [2, 4])
def test_dp2_greedy_rows_equal_one_device(rows, llama, pool2):
    prompts = PROMPTS[:rows]
    want = _jax_batch(llama, prompts, 8, 0.0)
    one = Engine(llama.pspec, llama.params(), device="cpu", batch=rows, **F32)
    v = llama.pspec.vocab_size
    assert one.generate_batch(prompts, 8, Sampler(v, 0.0, 0.9, 5)) == want
    assert _batch(pool2, llama, 1, 2, prompts, 8, 0.0) == want


def test_dp2_sampled_rows_equal_the_jax_stream(llama, pool2):
    want = _jax_batch(llama, PROMPTS, 8, 0.8, dp=2)
    assert _jax_batch(llama, PROMPTS, 8, 0.8) == want
    assert _batch(pool2, llama, 1, 2, PROMPTS, 8, 0.8) == want


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_dp2_tp2_rows_equal_the_jax_mesh_engine(temperature, llama, pool4):
    want = _jax_batch(llama, PROMPTS, 6, temperature, tp=2, dp=2,
                      activation_q80=True)
    assert _batch(pool4, llama, 2, 2, PROMPTS, 6, temperature,
                  activation_q80=True) == want


def test_a_batch_dp_does_not_divide_runs_replicated(llama, pool2):
    prompts = PROMPTS[:3]
    want = _jax_batch(llama, prompts, 6, 0.8)
    assert _batch(pool2, llama, 1, 2, prompts, 6, 0.8) == want


def test_device_loops_over_tp_ranks(llama, pool2):
    """decode_greedy_device and generate_device on a tp = 2 engine: the
    tokens of the same loops on one device."""
    v = llama.pspec.vocab_size
    calls = [("prefill", ([1, 5, 9],), {}),
             ("decode_greedy_device", (7, 10), {}),
             ("reset", (), {}),
             ("generate_device", ([1, 5, 9], 10),
              dict(temperature=0.8, topp=0.9, seed=3, vocab_size=v))]
    one = Engine(llama.pspec, llama.params(), device="cpu", **F32)
    want = []
    for m, a, kw in calls:
        r = getattr(one, m)(*a, **kw)
        want.append(r[0].tolist() if m == "decode_greedy_device" else r)
    res = pool2.run(ENGINE, 2, 1, llama.blob, F32, calls)
    for r in res:
        got = r["results"]
        assert got[1][0].tolist() == want[1]
        assert got[3] == want[3]


@pytest.mark.parametrize("tp", [1, 2])
def test_batch_device_loop_over_dp_ranks(tp, llama, pool2, pool4):
    """generate_batch_device at temperature 0.8 over dp = 2 (and a 2 x 2
    mesh, vocab sharded): one device's rows and loop steps, with a stop
    token that ends row 0 early (the third token it draws unstopped)."""
    kw = dict(temperature=0.8, topp=0.9, seed=7, vocab_size=llama.pspec.vocab_size)
    one = Engine(llama.pspec, llama.params(), device="cpu", batch=4, **F32)
    kw["eos_id"] = one.generate_batch_device(PROMPTS, 8, **kw)[0][2]
    want = one.generate_batch_device(PROMPTS, 8, **kw)
    assert len(want[0]) == 3
    calls = [("generate_batch_device", (PROMPTS, 8), kw),
             ("__getattribute__", ("last_device_steps",), {})]
    res = (pool2 if tp == 1 else pool4).run(ENGINE, tp, 2, llama.blob,
                                            dict(F32, batch=4), calls)
    for r in res:
        assert r["results"] == [want, one.last_device_steps]


@pytest.mark.parametrize("mode", ["generate", "inference", "device-sampling"])
def test_cli_dp2_prints_the_jax_cli_text(mode, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(dllama, "RANK_TIMEOUT_S", 60.0)
    mpath, tpath = write_fixture(tmp_path, seed=45)
    device = ["--device-sampling"] if mode == "device-sampling" else []
    common = [mode if device == [] else "generate", "--model", mpath,
              "--tokenizer", tpath, "--prompt", "hello", "--steps", "10",
              "--seed", "9", "--temperature", "0.8", "--compute-dtype", "f32",
              "--cache-dtype", "f32", "--dp", "2", *device]
    jax_dllama.main(common)
    want = capsys.readouterr().out.splitlines()
    dllama.main(common + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    start = next(k for k, line in enumerate(got) if line.startswith("💡"))
    jstart = next(k for k, line in enumerate(want) if line.startswith("💡"))
    assert got[start:start + 2] == want[jstart:jstart + 2]
    if mode == "inference":
        assert "(2 sequences)" in got[start + 2]
        assert got[start + 2] == want[jstart + 2]
