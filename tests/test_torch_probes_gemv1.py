"""The arithmetic and the work plan of the P3/P5 probe kernel
(csrc/q40_gemv1_probes.cu), mirrored in plain PyTorch in
ops/cuda_probes.py, and the probe tools' K1 rows and DECISION lines. The
kernel itself is held against its plain version on the card by
chip_smoke.py; the plain versions against the JAX repository's Pallas
probes in tests/test_torch_probes_gemv.py.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import cuda_probes
from distributed_llama_tpu_torch.quants.torch_codec import QuantizedTensor
from distributed_llama_tpu_torch.tools import exp_pk_decode, exp_scale_f16

# every finite f16 value, as f32
_BITS = np.arange(65536, dtype=np.uint16)
F16_SCALES = torch.from_numpy(
    _BITS[np.isfinite(_BITS.view(np.float16))].view(np.float16).astype(np.float32))


def _assert_magic_exact(v: torch.Tensor, s: torch.Tensor, p: int) -> None:
    """magic_times_scale(v, s, p) is v * s bit for bit for every pair of
    v and s (a zero product may come out +0 where v * s is -0: the FMA's
    2^(23-p) s - 2^(23-p) s), in chunks of scales."""
    for s_chunk in torch.split(s, 8192):
        got = cuda_probes.magic_times_scale(v[None, :], s_chunk[:, None], p)
        want = v[None, :].to(torch.float32) * s_chunk[:, None]
        zero = want == 0
        assert torch.equal(got[zero], torch.zeros_like(got[zero]))
        assert torch.equal(got[~zero].view(torch.int32), want[~zero].view(torch.int32))


def test_f16_scales_cover_every_finite_pattern():
    assert F16_SCALES.numel() == 63488


@pytest.mark.parametrize("p,top", [(p, 16) for p in cuda_probes.NIBBLE_PS] + [(0, 256)])
def test_magic_operand_is_exact(p, top):
    """The kept arithmetic: every nibble at every bit position the kernel
    uses (base's low and high nibbles, pk's high nibbles), and every byte at
    p = 0 (pk's low operand), OR'd into 2^(23-p) and less 2^(23-p), is the
    operand itself."""
    v = torch.arange(top)
    got = cuda_probes.magic_operand(v, p)
    assert torch.equal(got, v.to(torch.float32))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("p", cuda_probes.NIBBLE_PS)
def test_nibble_times_f16_scale_is_exact_at_every_position(p):
    """The "fma" body: base's low and high nibbles, and pk's high nibbles:
    every nibble at every bit position the kernel uses, times every finite
    f16 scale."""
    _assert_magic_exact(torch.arange(16), F16_SCALES, p)


def test_byte_times_f16_scale_is_exact():
    """The "fma" body: pk's low operand, the whole byte put into the magic
    constant's low byte (p = 0), times every finite f16 scale."""
    _assert_magic_exact(torch.arange(256), F16_SCALES, 0)


@pytest.mark.parametrize("p", cuda_probes.NIBBLE_PS)
def test_nibble_times_f32_scale_rounds_once(p):
    """The "fma" body with P5's f32 scales: the FMA rounds v * s once, so
    the dequantized value is the f32 product itself (random scales over a
    wide exponent range)."""
    gen = torch.Generator().manual_seed(p)
    s = torch.randn(65536, generator=gen) * torch.exp2(
        torch.randint(-40, 40, (65536,), generator=gen).to(torch.float32))
    _assert_magic_exact(torch.arange(16), s, p)


@pytest.mark.parametrize("n", [32, 1056, 4096])
@pytest.mark.parametrize("d", [1, 4, 5, 4096, 22016])
def test_items_cover_every_row_and_chunk_once(d, n):
    """The kernel's plan (rows a CTA for the H100's 132 SMs x 2 CTAs) and
    its chunk-major dealing of 4-row items to 8 warps: every (row, chunk)
    of the output exactly once, no CTA past the rows, every CTA within its
    partial sums' shared memory."""
    rows = cuda_probes.gemv1_rows(n, d, 264)
    chunks = -(-(n // 32) // 32)
    assert rows % cuda_probes.GEMV1_ITEM_ROWS == 0 and 4 <= rows <= 256
    assert chunks * rows * 4 <= cuda_probes.GEMV1_SMEM_MAX
    seen = np.zeros((d, chunks), dtype=np.int64)
    for cta, _, c, row0 in cuda_probes.gemv1_items(n, d, rows):
        assert cta * rows <= row0 < (cta + 1) * rows
        for r in range(row0, min(row0 + cuda_probes.GEMV1_ITEM_ROWS, d)):
            seen[r, c] += 1
    assert (seen == 1).all()
    assert -(-d // rows) <= 264


def test_plan_takes_one_wave_at_the_tools_shapes():
    """P3 attn (4096 rows): 16 rows a CTA, 256 CTAs; w1 and P5 (22016): 84
    rows, 263 CTAs, each within the 264 the H100 holds at once."""
    assert cuda_probes.gemv1_rows(4096, 4096, 264) == 16
    assert cuda_probes.gemv1_rows(4096, 22016, 264) == 84
    assert -(-22016 // 84) == 263


def _pk_inputs(d, n, seed):
    c = exp_pk_decode.make_case(d, n, seed, torch.device("cpu"))
    return c["x1"], c["x2"], c["xs"], c["w"]


@pytest.mark.parametrize("mode", cuda_probes.GEMV1_MODES)
def test_probe_sweep_entry_runs_the_plain_version_on_the_cpu(mode):
    """q40_gemv1_probe's product bodies are the wrappers' functions; the
    timing-only bodies have no plain version and raise; nothing counts."""
    before = (cuda_probes.q40_pk_gemv.launches, cuda_probes.q40_matmul_scales.launches)
    if mode in cuda_probes.PK_MODES:
        x1, x2, xs, w = _pk_inputs(8, 64, seed=3)
        args = (x1, x2[mode], xs, w)
        want = cuda_probes.q40_pk_gemv(mode, *args)
    else:
        gen = torch.Generator().manual_seed(4)
        sc = torch.rand((8, 2), generator=gen) * 0.004 + 0.001
        w = QuantizedTensor(torch.randint(0, 256, (8, 32), generator=gen, dtype=torch.uint8),
                            sc.to(torch.float16).view(torch.uint16) if mode == "u16" else sc)
        args = (torch.randn((1, 64), generator=gen), None, None, w)
        want = cuda_probes.q40_matmul_scales(args[0], w)
    for body in ("full", "other_loop", "fma"):
        assert torch.equal(cuda_probes.q40_gemv1_probe(mode, body, 0, *args), want)
    assert torch.equal(cuda_probes.q40_gemv1_probe(mode, "full", 0, *args, pdl=True), want)
    for body in ("loads", "empty"):
        with pytest.raises(ValueError, match="no plain version"):
            cuda_probes.q40_gemv1_probe(mode, body, 0, *args)
    for body, pdl in (("fast", False), ("fma", True), ("other_loop", True)):
        with pytest.raises(ValueError, match="body"):
            cuda_probes.q40_gemv1_probe(mode, body, 0, *args, pdl=pdl)
    assert (cuda_probes.q40_pk_gemv.launches, cuda_probes.q40_matmul_scales.launches) == before


def test_pk_decode_passes_time_k1_beside_each_shape(monkeypatch):
    """A K1 row per shape, on the copies the probe rotates through, each
    moving one K1 launch's bytes (bf16 x and out, f16 scales)."""
    monkeypatch.setattr(exp_pk_decode, "SHAPES", (("w1", 64, 256, 256), ("attn", 32, 256, 1024)))
    ps = exp_pk_decode.passes(torch.device("cpu"))
    assert [label for label, _, _ in ps] == ["w1 base", "w1 pk", "w1 K1",
                                            "attn base", "attn pk", "attn K1"]
    k1 = {label: nbytes for label, _, nbytes in ps if label.endswith("K1")}
    assert k1 == {"w1 K1": 64 * 128 + 64 * 8 * 2 + 256 * 2 + 64 * 2,
                  "attn K1": 32 * 128 + 32 * 8 * 2 + 256 * 2 + 32 * 2}
    for _, call, _ in ps:
        call()


@pytest.mark.parametrize("base,pk,verdict", [
    (1.00, 0.99, "does not beat base"),
    (1.00, 0.95, "pk beats base by more than 3% at w1, attn"),
])
def test_pk_decision_line(base, pk, verdict):
    ms = {f"{name} {m}": v for name in ("w1", "attn")
          for m, v in (("base", base), ("pk", pk), ("K1", 1.0))}
    line = exp_pk_decode.decision(ms)
    assert line.startswith("DECISION: ") and verdict in line
    assert f"w1 base/pk {base / pk:.3f}" in line


@pytest.mark.parametrize("f32,kind", [(1.09, "bytes-bound"), (1.02, "issue-bound"),
                                      (1.05, "mixed")])
def test_scale_decision_line(f32, kind):
    line = exp_scale_f16.decision({"u16 scales": 1.0, "f32 scales": f32, "K1": 0.9})
    assert line.startswith("DECISION: ") and line.endswith(f"{kind} at this shape")
    assert "u16 takes 1.111x K1's time" in line
