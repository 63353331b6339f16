"""A world of ranks to run the sharded drivers in: ``World(n)`` spawns
``n`` processes, each of which joins one ``torch.distributed`` process
group and then runs jobs collectively — ``world.run(fn, *args)`` calls
``fn(mesh, *args)`` on every rank with that rank's ``SeedMesh`` and
returns the ranks' results in rank order.

``fn`` and its arguments travel to the ranks by pickle, so ``fn`` is a
module-level function (its module is imported in each rank; the ranks
inherit the caller's ``sys.path``), and results come back the same way:
return host values, not CUDA tensors. A job that raises on any rank
stops the whole world and re-raises here with the rank's traceback.

Placement: on ``device="cuda"`` rank ``r`` runs on card ``r % count``
of the visible cards. The backend is ``nccl`` when every rank has a card
of its own and ``gloo`` otherwise (ranks sharing a card, or the CPU); an
explicit ``backend="nccl"`` with more ranks than cards raises.
"""

from __future__ import annotations

import atexit
import queue as _queue
import socket
import traceback
from datetime import timedelta
from typing import Optional

# seconds a collective may wait for a peer before the group gives up
# (a rank that raised leaves its peers waiting; the world is then torn
# down from the caller's side first)
COLLECTIVE_TIMEOUT_S = 600
# seconds the ranks may take to start and join their group
START_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pick_backend(n: int, device: str, backend: Optional[str]) -> str:
    import torch

    if device.startswith("cuda"):
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("a CUDA world was requested but no card is visible")
        if backend is None:
            return "nccl" if n <= cards else "gloo"
        if backend == "nccl" and n > cards:
            raise ValueError(
                f"nccl with {n} ranks on {cards} card(s): NCCL needs a card per "
                "rank; share a card over gloo"
            )
        return backend
    if backend not in (None, "gloo"):
        raise ValueError(f"backend {backend!r} cannot run on {device!r}; use gloo")
    return "gloo"


def _rank_main(rank, n, addr, backend, device, jobs, results):
    """One rank: join the group, then run jobs until told to stop. A
    job's exception (a failed check's ``SystemExit`` too) goes back to the
    caller with its traceback."""
    try:
        import torch
        import torch.distributed as dist

        from .mesh import seed_mesh

        if device.startswith("cuda"):
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            # the ranks are the parallelism: an eager step is hundreds of
            # small ops, which extra threads only slow down
            torch.set_num_threads(1)
            dev = torch.device(device)
        dist.init_process_group(
            backend, init_method=addr, world_size=n, rank=rank,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        )
        mesh = seed_mesh(device=dev)
        results.put((rank, "ready", None))
    except (Exception, SystemExit):
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args, kwargs = job
        try:
            results.put((rank, "ok", fn(mesh, *args, **kwargs)))
        except (Exception, SystemExit):
            results.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """``n`` ranks on ``device`` ("cpu" or "cuda"; None means CUDA and
    raises without a card) that run jobs collectively (see the module
    doc); a CPU rank runs one torch thread. Use as a context manager, or
    call ``close()``."""

    def __init__(self, n: int, device: Optional[str] = None, backend: Optional[str] = None):
        import multiprocessing as mp

        from .. import resolve_device

        if n < 1:
            raise ValueError(f"a world needs at least one rank, got {n}")
        self.n = n
        self.device = str(resolve_device(None) if device is None else device)
        self.backend = _pick_backend(n, self.device, backend)
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        addr = f"tcp://127.0.0.1:{_free_port()}"
        self._procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, n, addr, self.backend, self.device, self._jobs[r], self._results),
                # not daemonic: a rank may start processes of its own (the
                # checker's pool); close() ends the ranks, at exit too
                daemon=False,
            )
            for r in range(n)
        ]
        for p in self._procs:
            p.start()
        atexit.register(self.close, True)
        try:
            self._collect("ready", START_TIMEOUT_S)
        except BaseException:
            self.close(force=True)
            raise

    def _collect(self, what: str, timeout_s: Optional[float]) -> list:
        """One message per rank; a rank's error or death stops the world."""
        import time

        out = [None] * self.n
        have = 0
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while have < self.n:
            try:
                rank, kind, value = self._results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead:
                    self.close(force=True)
                    raise RuntimeError(f"rank(s) {dead} of the world exited during {what}")
                if deadline is not None and time.monotonic() > deadline:
                    self.close(force=True)
                    raise TimeoutError(f"the world's ranks did not finish {what}")
                continue
            if kind == "error":
                self.close(force=True)
                raise RuntimeError(f"rank {rank} failed during {what}:\n{value}")
            out[rank] = value
            have += 1
        return out

    def run(self, fn, *args, timeout_s: Optional[float] = None, **kwargs) -> list:
        """``fn(mesh, *args, **kwargs)`` on every rank; the results in
        rank order."""
        if not self._procs:
            raise RuntimeError("the world is closed")
        for q in self._jobs:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "a job"), timeout_s)

    def close(self, force: bool = False) -> None:
        """Stop every rank and wait for it to exit."""
        procs, self._procs = self._procs, []
        atexit.unregister(self.close)
        if not force:
            for q in self._jobs:
                q.put(None)
            for p in procs:
                p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)

