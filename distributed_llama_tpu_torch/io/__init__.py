from .model_file import read_spec, read_model, write_model, model_tensor_plan, HostTensor
from .tokenizer_file import read_tokenizer_file, write_tokenizer_file, TokenizerData

__all__ = [
    "read_spec",
    "read_model",
    "write_model",
    "model_tensor_plan",
    "HostTensor",
    "read_tokenizer_file",
    "write_tokenizer_file",
    "TokenizerData",
]
