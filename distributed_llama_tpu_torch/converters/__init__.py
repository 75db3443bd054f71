"""Offline tooling: checkpoint and tokenizer converters, copies of the JAX
package's converters/ (numpy and torch only) writing through the port's
io/model_file.py and io/tokenizer_file.py:

  hf.py                 HF safetensors -> .m   (ref: converter/convert-hf.py)
  meta_llama.py         Meta consolidated.pth -> .m (ref: converter/convert-llama.py)
  grok1.py              Grok-1 torch bins -> .m (ref: converter/convert-grok-1.py)
  tokenizer_spm.py      sentencepiece .model -> .t (ref: converter/convert-tokenizer-sentencepiece.py)
  tokenizer_llama3.py   tiktoken base64 vocab -> .t (ref: converter/convert-tokenizer-llama3.py)

Every writer streams tensor by tensor in the reference file order, so the
outputs load in either package and in the reference engine, and are byte
for byte the JAX converters' outputs on the same inputs. models/convert.py
(JAX params into the port's) is a different thing.
"""
