"""Measurement tools of the port: the shared kernel timer (`timing`) and the
design probes — the Q40 decode GEMV (`kernel_ladder`, `kernel_experiments`,
`exp_int8_dot`, `exp_pk_decode`, `exp_scale_f16`), the fp8-cache flash
decode (`exp_f8_flash`) and the prefill unpack/MMA overlap
(`exp_unpack_overlap`) — and the timing of every tile plan of K1's
tensor-core path (`k1_plans`), each run as
`python -m distributed_llama_tpu_torch.tools.<name>`."""
