"""Deterministic fault injection for the serving stack — the port's copy
of the JAX package's runtime/faults.py, with the sites the single-GPU
serving path fires. Each makes one failure shape a one-line,
count-deterministic trigger, so the resilience layer
(runtime/resilience.py) is testable on the CPU.

Named sites, fired on the host BEFORE any device launch (arming a fault
never changes a captured graph):

  * ``step_raise``    — scheduler step loop, start of a working
                        iteration: raises ``FaultError`` (the crash shape)
  * ``step_stall``    — same place: blocks for ``ms`` milliseconds or until
                        ``release()`` (the hang shape: only the watchdog
                        can detect it)
  * ``prefill_raise`` — Engine.slot_prefill_chunk entry: raises
                        ``FaultError`` mid-admission
  * ``slow_step``     — scheduler step loop: sleeps ``ms`` per fire (the
                        degraded-but-alive shape deadlines must catch)

Arming is test-driven (``FAULTS.arm(...)``) or from the environment for
subprocess harnesses:

    DLLAMA_FAULTS="step_raise:after=40;times=1,slow_step:ms=50;times=0"

``after=N`` skips the first N invocations of the site, ``times=K`` fires on
the next K (K=0: every invocation), ``ms=F`` sets the stall/sleep length.
Counters are per site and only grow, so an arm spec fires at the same
invocations on every run.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

SITES = ("step_raise", "step_stall", "prefill_raise", "slow_step")


class FaultError(RuntimeError):
    """The injected failure (its own type, so tests can tell an injected
    crash from a real one)."""


@dataclasses.dataclass
class _Armed:
    site: str
    after: int = 0     # skip this many invocations of the site first
    times: int = 1     # then fire on this many (0 = every one from there on)
    ms: float = 0.0    # stall/sleep milliseconds (step_stall / slow_step)
    hits: int = 0      # invocations seen
    fired: int = 0     # invocations that actually fired

    def should_fire(self) -> bool:
        self.hits += 1
        if self.hits <= self.after:
            return False
        if self.times and self.fired >= self.times:
            return False
        self.fired += 1
        return True


class FaultRegistry:
    """Thread-safe, count-deterministic fault trigger store. One process
    singleton (``FAULTS``); the scheduler and the engine call
    ``fire(site)`` at the named sites and pay one dict lookup when nothing
    is armed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, _Armed] = {}  # guarded by self._lock
        # a stalled site blocks on this event, so tests can release a
        # "hung" thread instead of leaking it for the stall duration
        self._release = threading.Event()

    def arm(self, site: str, *, after: int = 0, times: int = 1,
            ms: float = 0.0) -> None:
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (have {SITES})")
        with self._lock:
            self._release.clear()
            self._armed[site] = _Armed(site, after=after, times=times, ms=ms)

    def clear(self, site: str | None = None) -> None:
        """Disarm (one site or everything) and release any stall in
        progress: teardown must never leave a thread blocked."""
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)
            self._release.set()

    def release(self) -> None:
        """Unblock any thread currently inside a ``step_stall``."""
        self._release.set()

    def armed(self, site: str) -> bool:
        with self._lock:
            return site in self._armed

    def fired(self, site: str) -> int:
        with self._lock:
            a = self._armed.get(site)
            return a.fired if a else 0

    def fire(self, site: str) -> None:
        """Called at the named site. No-op unless armed; otherwise raises
        (``*_raise``), stalls (``step_stall``) or sleeps (``slow_step``)
        per the armed spec."""
        with self._lock:
            a = self._armed.get(site)
            if a is None or not a.should_fire():
                return
            ms, fired = a.ms, a.fired
        if site.endswith("_raise"):
            raise FaultError(f"injected {site} (fire #{fired})")
        if site == "step_stall":
            # block like a real hang: until released or ms elapses
            # (default: effectively forever, the watchdog's job)
            self._release.wait(timeout=(ms / 1e3) if ms else 3600.0)
            return
        if site == "slow_step" and ms:
            time.sleep(ms / 1e3)

    def load_env(self, env=None) -> None:
        """Parse ``DLLAMA_FAULTS`` (see the module docstring). A malformed
        spec raises ValueError: a mistyped chaos run must not silently
        measure a healthy system."""
        spec = (env if env is not None else os.environ).get(
            "DLLAMA_FAULTS", "")
        for part in filter(None, (p.strip() for p in spec.split(","))):
            site, _, opts = part.partition(":")
            kw: dict = {}
            for opt in filter(None, (o.strip() for o in opts.split(";"))):
                name, _, val = opt.partition("=")
                if name not in ("after", "times", "ms"):
                    raise ValueError(
                        f"bad DLLAMA_FAULTS option {opt!r} in {part!r}")
                kw[name] = float(val) if name == "ms" else int(val)
            self.arm(site, **kw)


FAULTS = FaultRegistry()
FAULTS.load_env()
