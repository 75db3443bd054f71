"""Two-node clusters of the port's CLI on the CPU, for the multi-node
tests: every node a `python -m distributed_llama_tpu_torch.apps.dllama`
process on 127.0.0.1, under a hard timeout (a hung cluster is the
regression these tests exist to catch, never a hung test run)."""

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "distributed_llama_tpu_torch.apps.dllama"
# a node's start (imports, the rendezvous, the tiny model) and its run
NODE_TIMEOUT_S = 120


def free_port_pair() -> int:
    """A port P with P and P + 1 free: the coordinator (the process
    group's TCP store) and the control star listen on them."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        try:
            with socket.socket() as s2:
                s2.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    raise RuntimeError("no two consecutive free ports")


def node(mode: str, argv: list, *, port: int, rank: int, nnodes: int = 2,
         env: dict | None = None, prelude: str | None = None
         ) -> subprocess.Popen:
    """One node of a cluster, started (stdout and stderr merged). With
    `prelude`, that Python source runs first in the node's process, then
    the CLI as `-m` would run it."""
    full = dict(os.environ, PYTHONUNBUFFERED="1", **(env or {}))
    if "DLLAMA_FAULTS" not in (env or {}):
        full.pop("DLLAMA_FAULTS", None)
    start = (["-m", CLI] if prelude is None else
             ["-c", f"{prelude}\nimport runpy\n"
                    f"runpy.run_module({CLI!r}, run_name='__main__')"])
    return subprocess.Popen(
        [sys.executable, *start, mode, *argv, "--nnodes", str(nnodes),
         "--node-rank", str(rank), "--coordinator", f"127.0.0.1:{port}",
         "--device", "cpu"],
        cwd=ROOT, env=full, stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen, timeout: float = NODE_TIMEOUT_S
           ) -> tuple[int, str]:
    """(exit code, output) of a node, killed past `timeout`."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=10)
        raise AssertionError(f"a node hung past {timeout} s:\n{out}")
    return proc.returncode, out


def run_cluster(root_mode: str, root_argv: list, worker_argv: list,
                nnodes: int = 2) -> tuple[tuple[int, str], list]:
    """A whole cluster run: the root in `root_mode` and nnodes - 1
    `worker` nodes; ((root code, root output), [(code, output), ...])."""
    port = free_port_pair()
    workers = [node("worker", worker_argv, port=port, rank=r, nnodes=nnodes)
               for r in range(1, nnodes)]
    root = node(root_mode, root_argv, port=port, rank=0, nnodes=nnodes)
    try:
        got = finish(root)
    finally:
        outs = [finish(w) for w in workers]
    return got, outs


def text_from(out: str, marker: str = "💡") -> list[str]:
    """The output's lines from the first that starts with `marker`, less
    the process group's socket warnings on stderr."""
    lines = [ln for ln in out.splitlines() if not ln.startswith("[W")]
    return lines[next(i for i, ln in enumerate(lines)
                      if ln.startswith(marker)):]


def wait_line(proc: subprocess.Popen, needle: str,
              timeout: float = NODE_TIMEOUT_S) -> list[str]:
    """Read a node's output until a line holding `needle`; the lines read
    (whole lines; what followed in the same read comes last). Reads the
    pipe's descriptor itself: a buffered readline after select() would
    leave lines in the reader's buffer that select() no longer sees."""
    import selectors

    fd = proc.stdout.fileno()
    sel = selectors.DefaultSelector()
    sel.register(fd, selectors.EVENT_READ)
    lines: list[str] = []
    buf = b""
    end = time.monotonic() + timeout
    try:
        while time.monotonic() < end:
            if not sel.select(timeout=0.2):
                continue
            chunk = os.read(fd, 65536)
            if not chunk:
                break
            buf += chunk
            *whole, buf = buf.split(b"\n")
            lines += [ln.decode(errors="replace") + "\n" for ln in whole]
            if any(needle in ln for ln in lines):
                if buf:
                    lines.append(buf.decode(errors="replace"))
                return lines
    finally:
        sel.close()
    proc.kill()
    raise AssertionError(f"{needle!r} never appeared within {timeout} s: "
                         f"{''.join(lines)}{buf.decode(errors='replace')}")
