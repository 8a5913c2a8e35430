"""Process-group bootstrap and the multi-process launcher.

Twin of ``apex_tpu/parallel/multiproc.py``.  One process per GPU, as the
reference runs (NCCL takes one rank per GPU).
``initialize_distributed()`` reads the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
starts ``torch.distributed``: NCCL for the card, gloo for
``device="cpu"``.  ``python -m apex_tpu_torch.parallel.multiproc
SCRIPT [args...]`` starts ``WORLD_SIZE`` copies of a script with that
environment set, ranks above 0 logging to ``PROC_<rank>.log`` (the
reference launcher's ``GPU_<i>.log``).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch._device import resolve_device


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked (for a one-host
    group's ``init_method``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(device="cuda", *, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> int:
    """Start the default process group; returns this process's rank.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``
    (1 and 0), ``init_method`` to ``tcp://MASTER_ADDR:MASTER_PORT``.  A
    world of one with no ``init_method`` starts nothing and returns 0; a
    larger world with no address raises rather than run alone.  On the
    card the backend is NCCL (missing NCCL raises) and the process takes
    the GPU ``LOCAL_RANK``; with ``device="cpu"`` it is gloo."""
    dev = resolve_device(device)
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if init_method is None:
        if world_size <= 1:
            return 0
        if "MASTER_ADDR" not in env:
            raise RuntimeError(
                f"WORLD_SIZE={world_size} but no MASTER_ADDR: set "
                "MASTER_ADDR (and MASTER_PORT) or pass init_method. "
                "Refusing to silently run single-process.")
        init_method = (f"tcp://{env['MASTER_ADDR']}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return rank


def main(argv=None) -> int:
    """Start ``WORLD_SIZE`` (default: the visible GPU count, at least 1)
    copies of ``argv`` (a script and its arguments) with ``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` (default
    ``127.0.0.1``) and ``MASTER_PORT`` (default 29500) set; waits for
    all and returns their OR-ed exit codes."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("usage: python -m apex_tpu_torch.parallel.multiproc SCRIPT "
              "[args...]", file=sys.stderr)
        return 2
    world = int(os.environ.get("WORLD_SIZE",
                               max(torch.cuda.device_count(), 1)))
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(world), MASTER_ADDR=addr,
                       MASTER_PORT=port)
            out = None
            if rank != 0:
                out = open(f"PROC_{rank}.log", "w")
                logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable] + argv, env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None))
        rc = 0
        for p in procs:
            rc |= p.wait()
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


if __name__ == "__main__":
    sys.exit(main())
