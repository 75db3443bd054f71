from .types import FloatType, BLOCK_SIZE, batch_bytes, numbers_per_batch
from .numpy_codec import (
    quantize_q40,
    dequantize_q40,
    quantize_q80,
    dequantize_q80,
    q40_bytes_to_arrays,
    q40_arrays_to_bytes,
    q80_bytes_to_arrays,
    q80_arrays_to_bytes,
)
from .torch_codec import (QuantizedTensor, dequantize_q40_torch,
                          dequantize_q80_torch, quantize_q80_torch)

__all__ = [
    "FloatType",
    "BLOCK_SIZE",
    "batch_bytes",
    "numbers_per_batch",
    "quantize_q40",
    "dequantize_q40",
    "quantize_q80",
    "dequantize_q80",
    "q40_bytes_to_arrays",
    "q40_arrays_to_bytes",
    "q80_bytes_to_arrays",
    "q80_arrays_to_bytes",
    "QuantizedTensor",
    "dequantize_q40_torch",
    "quantize_q80_torch",
    "dequantize_q80_torch",
]
