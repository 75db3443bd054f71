"""Measurement tools of the port: the shared kernel timer (`timing`) and the
Q40 decode-GEMV design probes (`kernel_ladder`, `kernel_experiments`,
`exp_int8_dot`), each run as `python -m distributed_llama_tpu_torch.tools.<name>`."""
