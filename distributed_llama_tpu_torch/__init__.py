"""distributed_llama_tpu_torch — the PyTorch/CUDA port of distributed_llama_tpu.

Runs the same `.m`/`.t` files on an NVIDIA H100. Plain tensor code is
PyTorch; the JAX package's Pallas kernels are CUDA C++ kernels written for
sm_90a (csrc/), built with nvcc at first use and bound through ctypes.
The layout mirrors the JAX package so each module's counterpart is found
under the same path:

  quants/    Q40/Q80 block codecs (host numpy + device torch)
  ops/       rmsnorm, rope, activations, attention, matmul, CUDA kernels
  models/    Llama forward, params, streamed loader, JAX-params converter
  io/        .m model-file and .t tokenizer-file formats
  runtime/   inference engine, stats
  apps/      dllama CLI (inference / generate)

The package imports torch, never jax, and nothing of distributed_llama_tpu.
"""

__version__ = "0.1.0"
