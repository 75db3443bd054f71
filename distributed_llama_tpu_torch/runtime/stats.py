"""Per-step timing stats.

Parity with the reference's benchmark surface: per-token G/I lines and
end-of-run averages (ref: src/apps/dllama/dllama.cpp:47-91). The port's copy
of the JAX package's StepStats/RunStats: generation wall ms (G), device-step
ms (I, the step up to its logits on the host — the copy is the sync point),
and host overhead ms (sampling + bookkeeping).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StepStats:
    generation_ms: float = 0.0  # wall time of the whole token step (G)
    device_ms: float = 0.0      # device execution + logits D2H transfer (I) —
                                # the transfer is the sync point, so it cannot
                                # be separated from device time
    host_ms: float = 0.0        # host-side sampling/bookkeeping


@dataclasses.dataclass
class RunStats:
    steps: list[StepStats] = dataclasses.field(default_factory=list)

    def add(self, s: StepStats) -> None:
        self.steps.append(s)

    def averages(self, skip_first: int = 1) -> StepStats:
        """Average over steps, skipping warmup/compile steps (the reference
        averages all 16 samples; we exclude the compile step)."""
        body = self.steps[skip_first:] or self.steps
        n = len(body)
        return StepStats(
            generation_ms=sum(s.generation_ms for s in body) / n,
            device_ms=sum(s.device_ms for s in body) / n,
            host_ms=sum(s.host_ms for s in body) / n,
        )
