"""A process-tree watchdog that no lock of the watched process can hold up.

    python -m distributed_llama_tpu_torch.tools.watchdog PID SECONDS

waits SECONDS, or until its standard input closes or PID is no longer its
parent (the watched process ended: it exits 0). At the deadline it sends
SIGUSR1 to PID and then to every process below PID, one at a time (a
process that registered faulthandler on SIGUSR1 prints every thread's
stack to its stderr, from C, without the interpreter lock), kills every
process below PID and then PID, and exits 3. Start it from PID with
stdin=subprocess.PIPE and keep the pipe open while PID runs. It imports
the standard library only.
"""

from __future__ import annotations

import contextlib
import os
import select
import signal
import sys
import time
from pathlib import Path


def descendants(pid: int) -> list[int]:
    """Every process below `pid`, read from /proc, parents first."""
    kids: dict[int, list[int]] = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            kids.setdefault(ppid, []).append(int(d.name))
    out, todo = [], [pid]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append(c)
            todo.append(c)
    return out


def signal_tree(procs: list[int], pause_s: float = 0.5) -> None:
    """SIGUSR1 to each of procs in turn (their stacks, one at a time),
    then SIGKILL to each, the last first (procs parents first: the
    leaves go before their parents)."""
    for p in procs:
        with contextlib.suppress(OSError):
            os.kill(p, signal.SIGUSR1)
        time.sleep(pause_s)
    for p in reversed(procs):
        with contextlib.suppress(OSError):
            os.kill(p, signal.SIGKILL)


def watch(pid: int, seconds: float) -> int:
    end = time.monotonic() + seconds
    while (left := end - time.monotonic()) > 0:
        ready, _, _ = select.select([sys.stdin], [], [], min(left, 1.0))
        if (ready and not os.read(sys.stdin.fileno(), 1)) or os.getppid() != pid:
            return 0
    print(f"watchdog: pid {pid} still running after {seconds:.0f} s; its stacks "
          "and its processes' stacks follow on their stderr, then every one is "
          "killed", file=sys.stderr, flush=True)
    me = os.getpid()
    signal_tree([pid] + [p for p in descendants(pid) if p != me], pause_s=1.0)
    return 3


if __name__ == "__main__":
    sys.exit(watch(int(sys.argv[1]), float(sys.argv[2])))
