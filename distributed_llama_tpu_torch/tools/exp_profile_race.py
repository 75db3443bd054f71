"""Does POST /admin/profile hang a serving process on the card?

    python -m distributed_llama_tpu_torch.tools.exp_profile_race [--captures N]

Serves `dllama api --serve-batch 4 --serve-chunk 256` in-process on
Llama-2-7B (bench.py:101 widths, all 32 layers, synthetic Q40 weights from
seed 0, Q80 activations), as chip_smoke.py's phase 10 does, and N times:
starts 4 streaming completions (a 40-word prompt, 96 tokens each) and,
after a pause that moves through 0.05-0.65 s, POSTs /admin/profile?ms=W
(W cycling through 20, 50, 100 and 200), then joins every request. The
profiler's start and stop thus land beside the scheduler's decode graph
replays and prefill chunks at many phases. One line a capture gives its
index and seconds; the last line is a JSON object with the count done.

A capture that hangs the process hangs this tool with it (a thread holding
the interpreter lock stops any in-process timer): run it under `timeout -s
USR1 -k 10 SECONDS`, and read how far it got from its last line; on
SIGUSR1 faulthandler prints every thread's stack to stderr.
"""

from __future__ import annotations

import argparse
import faulthandler
import http.client
import json
import signal
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from ..apps import api_server
from ..io import TokenizerData
from ..models.params import synthetic_q40_params
from ..models.spec import ArchType, HiddenAct, ModelSpec
from ..ops import cuda_build
from ..runtime.engine import Engine
from ..sampler import Sampler
from ..testing import byte_fallback_vocab
from ..tokenizer import Tokenizer

WINDOWS_MS = (20, 50, 100, 200)


def _post(addr, route: str, body: dict):
    conn = http.client.HTTPConnection(*addr, timeout=180)
    conn.request("POST", route, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--captures", type=int, default=40)
    args = ap.parse_args()
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    if not torch.cuda.is_available():
        raise SystemExit("exp_profile_race needs a CUDA device")
    cuda_build.build_all()
    spec = ModelSpec(arch=ArchType.LLAMA, dim=4096, hidden_dim=11008, n_layers=32,
                     n_heads=32, n_kv_heads=32, vocab_size=32000, seq_len=2048,
                     hidden_act=HiddenAct.SILU)
    vocab = spec.vocab_size
    tokenizer = Tokenizer(TokenizerData(vocab=byte_fallback_vocab(vocab),
                                        scores=[0.0] * vocab, bos_id=1, eos_id=2))
    params = synthetic_q40_params(spec, seed=0, device="cuda")
    engine = Engine(spec, params, device="cuda", activation_q80=True)
    rng = np.random.default_rng(31)

    def words(k):
        return " ".join("".join(chr(97 + c) for c in rng.integers(0, 26, 5))
                        for _ in range(k))

    done = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        state = api_server.ApiState(engine, tokenizer, Sampler(vocab, 0.0, 0.9, 3),
                                    model_name="llama2-7b-synthetic", serve_batch=4,
                                    serve_chunk=256, profile_dir=d)
        server = ThreadingHTTPServer(("127.0.0.1", 0), api_server.make_handler(state))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        addr = server.server_address[:2]
        print(f"[race] serving after {time.perf_counter() - t0:.1f} s", flush=True)
        try:
            for i in range(args.captures):
                res: dict = {}

                def call(key, route, body):
                    res[key] = _post(addr, route, body)
                streams = [threading.Thread(target=call, args=(
                    j, "/v1/completions", {"prompt": words(40), "max_tokens": 96,
                                           "temperature": 0, "stream": True}))
                    for j in range(4)]
                for t in streams:
                    t.start()
                time.sleep(0.05 + 0.6 * (i * 7 % args.captures) / args.captures)
                ms = WINDOWS_MS[i % len(WINDOWS_MS)]
                c0 = time.perf_counter()
                call("profile", f"/admin/profile?ms={ms}", {})
                c_s = time.perf_counter() - c0
                for t in streams:
                    t.join(timeout=180)
                codes = [res.get(j, (None,))[0] for j in range(4)]
                if res["profile"][0] != 200 or codes != [200] * 4:
                    raise SystemExit(f"capture {i}: /admin/profile {res['profile'][0]}, "
                                     f"streams {codes}")
                done += 1
                print(f"[race] capture {i} (ms={ms}) returned in {c_s:.3f} s", flush=True)
        finally:
            server.shutdown()
            server.server_close()
            api_server.finish(state, drain_timeout=30.0)
    print(json.dumps({"captures": done, "seconds": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
