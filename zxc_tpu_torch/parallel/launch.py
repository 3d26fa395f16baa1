"""Start ``n`` rank processes of a function of this package, joined in
one ``torch.distributed`` process group.

    from zxc_tpu_torch.parallel import launch
    results = launch.launch("zxc_tpu_torch.parallel.jobs:run_jobs", 4,
                            args=(spec_path,), device="cpu")

Each rank runs ``python -m zxc_tpu_torch.parallel`` with its rank,
the world size and a free local port: it joins the group
(``tcp://localhost:<port>``; gloo for ``device="cpu"``, NCCL for
``"cuda"`` unless ``backend`` says otherwise), calls the function with
``args`` (strings) and leaves the group. A CPU rank runs one thread; a
cuda rank takes card ``rank % device_count``. Each rank has its own wall
timeout (it dumps its stack and exits), and the process group the same
timeout. The launch returns each rank's exit code and output, or raises
``LaunchError`` with the traceback of the rank that failed, as soon as
one fails or the timeout passes, after killing the rest: a rank waiting
in a collective for a dead peer never holds the caller.

The ranks import this package and what the function imports, nothing
of the caller's (no test module, no JAX).
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PKG = "zxc_tpu_torch"


class LaunchError(RuntimeError):
    """A rank failed, or the launch outlived its timeout."""


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    mod, _, name = target.partition(":")
    if not name or not (mod == _PKG or mod.startswith(_PKG + ".")):
        raise ValueError(f"launch target {target!r} is not "
                         f"'{_PKG}.<module>:<function>'")
    return getattr(importlib.import_module(mod), name)


def launch(target: str, n: int, args: tuple = (), *, device: str = "cpu",
           backend: str | None = None, timeout: float = 300.0
           ) -> list[RankResult]:
    """Run ``target`` ("zxc_tpu_torch.<module>:<function>") on ``n``
    ranks and wait for them: a RankResult a rank, in rank order.
    ``device`` is "cpu" (gloo) or "cuda" (NCCL by default; "gloo" shares
    one card between ranks). Raises LaunchError when a rank fails or
    ``timeout`` seconds pass."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"launch runs on cpu or cuda, not {device!r}")
    backend = backend or ("gloo" if device == "cpu" else "nccl")
    _resolve(target)
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    with tempfile.TemporaryDirectory(prefix="zxc-launch-") as tmp:
        try:
            for rank in range(n):
                out = open(os.path.join(tmp, f"{rank}.out"), "w+")
                err = open(os.path.join(tmp, f"{rank}.err"), "w+")
                logs.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", f"{_PKG}.parallel",
                     target, str(rank), str(n), str(port), backend, device,
                     str(timeout), *map(str, args)],
                    env=env, stdout=out, stderr=err, stdin=subprocess.DEVNULL))
            _wait(procs, logs, timeout)
            return [RankResult(r, p.returncode, *_read(logs[r]))
                    for r, p in enumerate(procs)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for out, err in logs:
                out.close()
                err.close()


def _read(log) -> tuple[str, str]:
    texts = []
    for f in log:
        f.flush()
        f.seek(0)
        texts.append(f.read())
    return tuple(texts)


def _wait(procs, logs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            # the first failure takes its peers down with it; name every
            # rank that has failed so far, the first one first
            msgs = [f"rank {r} failed (exit code {codes[r]}):\n"
                    f"{_read(logs[r])[1][-4000:]}" for r in failed]
            raise LaunchError("\n".join(msgs))
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            late = [r for r, c in enumerate(codes) if c is None]
            raise LaunchError(f"ranks {late} still running after "
                              f"{timeout} s")
        time.sleep(0.02)


def rank_main(argv: list[str]) -> None:
    """A rank's process (``python -m zxc_tpu_torch.parallel``): target,
    rank, world size, port, backend, device, timeout, then the args."""
    target, rank, world, port, backend, device, timeout = argv[:7]
    rank, world, timeout = int(rank), int(world), float(timeout)
    import datetime
    import faulthandler
    import traceback

    import torch
    import torch.distributed as dist

    faulthandler.dump_traceback_later(timeout, exit=True)
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        fn = _resolve(target)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        fn(*argv[7:])
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        # a peer may be waiting in a collective: leave without the
        # interpreter's teardown, which could wait for it
        os._exit(1)
