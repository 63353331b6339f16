"""Seed-sweep test driver (ref madsim/src/sim/runtime/builder.rs:7-162).

Reads ``MADSIM_TEST_{SEED,NUM,JOBS,PROCS,CONFIG,TIME_LIMIT,
CHECK_DETERMINISM}`` and ``MADSIM_ALLOW_SYSTEM_THREAD`` from the
environment, runs ``count`` seeds (seed, seed+1, ...) with ``jobs``
concurrent OS threads (one fresh thread per seed, like the reference's
``std::thread::spawn`` + ``buffer_unordered``) or — for CPU-bound sweeps
that Python threads would GIL-serialize — ``procs`` forked worker
processes, and on failure prints the reproducing ``MADSIM_TEST_SEED``
(ref runtime/mod.rs:205-210).

The ``@sim_test`` decorator is the analogue of ``#[madsim::test]``
(madsim-macros/src/lib.rs:88-152): it rewrites an async test into a sync
function that drives ``Builder.from_env().run(...)`` — directly collectable
by pytest.
"""

from __future__ import annotations

import functools
import os
import sys
import threading
from typing import Any, Callable, Coroutine, List, Optional

from .config import Config
from .runtime import Runtime

AsyncFn = Callable[..., Coroutine[Any, Any, Any]]


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "False")


class ProcsDeviceTierError(RuntimeError):
    """A ``procs``-sweep child attempted to use torch / the device tier.

    Children are forked from a parent where torch may already hold
    threads and a CUDA context; CUDA cannot be re-initialized in a
    forked child ("Cannot re-initialize CUDA in forked subprocess") and
    may hang instead of failing cleanly. Device-tier seed parallelism is
    ``engine.core.run_sweep`` (seeds as tensor lanes), not OS processes.
    """

    def __init__(self, what: str = "torch"):
        super().__init__(
            f"device-tier workload under Builder(procs=N): {what} is not "
            f"usable in a forked sweep child (torch and CUDA state do not "
            f"survive fork). Use procs for HOST-tier workloads only; for "
            f"parallel device seeds use madsim_tpu_torch.engine.core.run_sweep, "
            f"which batches seeds as tensor lanes on one process."
        )


def _is_device_tier(name: str) -> bool:
    return name == "torch" or name.startswith("torch.")


def _poison_device_tier_in_child() -> None:
    """Make any torch use inside a forked procs child raise the named
    error instead of hanging: every already-imported ``torch*`` module is
    replaced in sys.modules by a stub whose attribute access raises (a
    sys.modules hit precedes the finders), and a meta-path finder refuses
    FRESH ``import torch`` too. Port modules imported before the fork hold
    real torch references the poison cannot reach, so the engine checks
    the child's sentinel itself (``engine.core._procs_child_guard``)."""
    import importlib.abc
    import types

    class _Poisoned(types.ModuleType):
        def __getattr__(self, name):  # noqa: D105
            if name.startswith("__"):  # repr/spec introspection stays safe
                raise AttributeError(name)
            raise ProcsDeviceTierError(f"{self.__name__}.{name}")

    for name in [n for n in sys.modules if _is_device_tier(n)]:
        sys.modules[name] = _Poisoned(name)

    class _DeviceImportBlocker(importlib.abc.MetaPathFinder):
        def find_spec(self, fullname, path=None, target=None):
            if _is_device_tier(fullname):
                raise ProcsDeviceTierError(f"import {fullname}")
            return None

    sys.meta_path.insert(0, _DeviceImportBlocker())


class Builder:
    """Configurable multi-seed test runner (ref ``Builder``, builder.rs)."""

    def __init__(
        self,
        seed: Optional[int] = None,
        count: int = 1,
        jobs: int = 1,
        procs: int = 1,
        config: Optional[Config] = None,
        time_limit: Optional[float] = None,
        check_determinism: bool = False,
        allow_system_thread: bool = False,
    ):
        if seed is None:
            import time as _walltime

            seed = _walltime.time_ns()  # new schedule per run (builder.rs:64-73)
        self.seed = seed
        self.count = count
        self.jobs = jobs
        self.procs = procs
        self.config = config
        self.time_limit = time_limit
        self.check_determinism = check_determinism
        self.allow_system_thread = allow_system_thread

    @classmethod
    def from_env(cls, **overrides: Any) -> "Builder":
        """ref builder.rs:63-117."""
        cfg: Optional[Config] = None
        cfg_path = os.environ.get("MADSIM_TEST_CONFIG")
        if cfg_path:
            with open(cfg_path, "r") as f:
                cfg = Config.from_toml(f.read())
        kwargs: dict = dict(
            seed=_env_int("MADSIM_TEST_SEED"),
            count=_env_int("MADSIM_TEST_NUM") or 1,
            jobs=_env_int("MADSIM_TEST_JOBS") or 1,
            procs=_env_int("MADSIM_TEST_PROCS") or 1,
            config=cfg,
            time_limit=(
                float(os.environ["MADSIM_TEST_TIME_LIMIT"])
                if os.environ.get("MADSIM_TEST_TIME_LIMIT")
                else None
            ),
            check_determinism=_env_flag("MADSIM_TEST_CHECK_DETERMINISM"),
            allow_system_thread=_env_flag("MADSIM_ALLOW_SYSTEM_THREAD"),
        )
        for k, v in overrides.items():
            if v is not None:
                kwargs[k] = v
        return cls(**kwargs)

    def _run_one(self, seed: int, test_fn: Callable[[], Coroutine]) -> Any:
        if self.check_determinism:
            return Runtime.check_determinism(seed, test_fn, config=self.config)
        rt = Runtime(seed=seed, config=self.config)
        if self.time_limit is not None:
            rt.set_time_limit(self.time_limit)
        rt.set_allow_system_thread(self.allow_system_thread)
        return rt.block_on(test_fn())

    def run(self, test_fn: Callable[[], Coroutine]) -> Any:
        """Run the async test over ``count`` seeds (ref builder.rs:120-161)."""
        seeds = list(range(self.seed, self.seed + self.count))
        if self.procs > 1 and self.count > 1:
            return self._run_procs(seeds, test_fn)
        if self.jobs <= 1 or self.count == 1:
            last = None
            for seed in seeds:
                try:
                    last = self._run_one(seed, test_fn)
                except BaseException:
                    _print_repro(seed)
                    raise
            return last

        failures: List[tuple] = []
        results: dict = {}
        lock = threading.Lock()
        sem = threading.Semaphore(self.jobs)

        def worker(seed: int) -> None:
            try:
                r = self._run_one(seed, test_fn)
                with lock:
                    results[seed] = r
            except BaseException as e:  # noqa: BLE001
                with lock:
                    failures.append((seed, e))
            finally:
                sem.release()

        threads = []
        for seed in seeds:
            sem.acquire()
            if failures:
                sem.release()
                break
            t = threading.Thread(target=worker, args=(seed,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if failures:
            failures.sort(key=lambda f: f[0])
            seed, exc = failures[0]
            _print_repro(seed)
            raise exc
        # match the sequential path: the last seed's result
        return results[max(results)] if results else None


    def _run_procs(self, seeds: List[int], test_fn) -> Any:
        """Fork-based parallel sweep: ``procs`` OS processes, each running
        an interleaved shard of the seed range sequentially.

        The reference's sweep parallelism is real OS threads
        (builder.rs:120-161 buffer_unordered); Python threads serialize on
        the GIL for this CPU-bound work, so the multi-core path uses
        processes instead. Per-seed isolation is total (each child builds
        fresh Runtimes), so schedules are identical to the sequential
        sweep. Fork start method: the test function is inherited, never
        pickled; results cross back over a queue (unpicklable results
        degrade to None; the sequential path is unaffected).

        Constraint: procs-mode workloads must stay HOST-tier. Children are
        forked from a possibly multithreaded parent (torch starts thread
        pools, CUDA a context), and neither survives fork — the
        device-tier path for parallel seeds is ``engine.core.run_sweep``,
        which batches seeds as tensor lanes instead of processes.
        """
        import multiprocessing as mp
        import pickle as _pickle
        import queue as _queue
        import traceback as _tb

        ctx = mp.get_context("fork")
        q = ctx.Queue()
        stop = ctx.Event()  # cooperative fail-fast (never terminate():
        # killing a child mid-Queue.put corrupts the queue's pipe frame
        # and hangs every later get())

        import io
        import os as _os

        def emit(buf: io.StringIO) -> None:
            # one os.write per seed: atomic on a pipe for payloads up to
            # PIPE_BUF (4 KiB on Linux — larger seed outputs may interleave
            # with other children, but are never LOST: the loop finishes
            # partial writes), vs Python's two-write print which garbles a
            # shared fd even for short lines
            data = memoryview(buf.getvalue().encode())
            try:
                fd = sys.stdout.fileno()
            except (OSError, ValueError):  # captured stdout (pytest)
                sys.stdout.write(buf.getvalue())
                sys.stdout.flush()
                return
            while data:
                try:
                    n = _os.write(fd, data)
                except OSError:
                    # e.g. non-blocking fd: push only the REMAINING bytes
                    # through the buffered layer (re-writing the whole
                    # buffer would duplicate what already reached the fd)
                    rest = bytes(data)
                    stream = getattr(sys.stdout, "buffer", None)
                    if stream is not None:
                        stream.write(rest)
                        stream.flush()
                    else:
                        sys.stdout.write(rest.decode(errors="replace"))
                        sys.stdout.flush()
                    return
                data = data[n:]

        def child(shard: List[int]) -> None:
            # structural fork-safety: device-tier use fails fast by name
            # instead of hanging in inherited torch/CUDA state. The
            # sentinel is pid-scoped so it only flags THIS forked process —
            # an exec'd descendant (fresh interpreter, no inherited state)
            # may use the engine legitimately
            os.environ["MADSIM_IN_PROCS_CHILD"] = str(os.getpid())
            _poison_device_tier_in_child()
            try:
                for s in shard:
                    if stop.is_set():
                        return  # another shard failed; stop between seeds
                    buf = io.StringIO()
                    prev_out = sys.stdout
                    sys.stdout = buf  # group this seed's prints
                    try:
                        r = self._run_one(s, test_fn)
                    except BaseException:  # noqa: BLE001 - reported to parent
                        sys.stdout = prev_out
                        emit(buf)
                        q.put(("err", s, _tb.format_exc()))
                        return
                    sys.stdout = prev_out
                    emit(buf)
                    # pickle HERE, once: Queue.put pickles lazily in a
                    # feeder thread, so a put-side try/except never fires —
                    # the result would be silently dropped instead of
                    # degrading to None. Shipping the bytes avoids
                    # double-serializing every result.
                    try:
                        blob = _pickle.dumps(r)
                    except Exception:
                        blob = None
                    q.put(("ok", s, blob))
            finally:
                q.put(("done", shard[0], None))

        n = min(self.procs, len(seeds))
        shards = [seeds[i::n] for i in range(n)]
        procs = [ctx.Process(target=child, args=(sh,), daemon=True) for sh in shards]
        for p in procs:
            p.start()
        # drain WHILE children run — joining first deadlocks once queued
        # results exceed the pipe capacity (children block in q.put); the
        # sentinel counts children that finished, and a liveness check
        # covers children killed without one (segfault/OOM)
        results: dict = {}
        failures: List[tuple] = []
        done = 0
        while done < n:
            try:
                kind, s, payload = q.get(timeout=0.5)
            except _queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break  # crashed child(s); nothing more is coming
                continue
            if kind == "ok":
                results[s] = None if payload is None else _pickle.loads(payload)
            elif kind == "err":
                failures.append((s, payload))
                # fail fast like the jobs path: stop COOPERATIVELY (the
                # other shards finish their in-flight seed, then exit —
                # so an also-failing lower seed still reports and wins
                # the repro print, and the queue stays intact)
                stop.set()
            else:
                done += 1
        for p in procs:
            p.join()
        if not failures:
            # a worker died without reporting (segfault/OOM): attribute
            # the death to the first seed its shard never reported — the
            # one it was running
            reported = set(results)
            for p, shard in zip(procs, shards):
                if p.exitcode not in (0, None):
                    unreported = [s for s in shard if s not in reported]
                    culprit = unreported[0] if unreported else shard[0]
                    failures.append(
                        (culprit,
                         f"worker running shard {shard} died with exit code "
                         f"{p.exitcode} around seed {culprit} (no traceback "
                         f"crossed the process boundary)")
                    )
        if failures:
            failures.sort(key=lambda f: f[0])
            s, tb_text = failures[0]
            _print_repro(s)
            raise SimSweepError(
                f"seed {s} failed in a sweep worker process:\n{tb_text}"
            )
        return results[max(results)] if results else None


class SimSweepError(RuntimeError):
    """A seed failed inside a process-sweep worker; carries the child's
    formatted traceback (the original exception object lives in the child
    — rerun with the printed MADSIM_TEST_SEED to debug it in-process)."""


def _print_repro(seed: int) -> None:
    print(
        f"note: run with `MADSIM_TEST_SEED={seed}` environment variable "
        f"to reproduce this failure",
        file=sys.stderr,
    )
    if sys.flags.hash_randomization and os.environ.get("PYTHONHASHSEED") in (
        None, "", "random",
    ):
        # the reference interposes HashMap seeding (sim/rand.rs:176-184);
        # Python's str-hash salt is fixed at interpreter start and cannot
        # be interposed, so iteration order of str-keyed sets/dicts-from-
        # sets can differ in a NEW process. Tell the user how to pin it.
        print(
            "note: PYTHONHASHSEED is unset — if the failure does not "
            "reproduce and the workload iterates str-keyed sets, also pin "
            "`PYTHONHASHSEED=0` (Python's hash salt is per-process and "
            "outside the simulator's control)",
            file=sys.stderr,
        )


def sim_test(
    fn: Optional[AsyncFn] = None,
    *,
    seed: Optional[int] = None,
    count: Optional[int] = None,
    jobs: Optional[int] = None,
    procs: Optional[int] = None,
    config: Optional[Config] = None,
    time_limit: Optional[float] = None,
    check_determinism: Optional[bool] = None,
    allow_system_thread: Optional[bool] = None,
) -> Any:
    """``#[madsim::test]`` analogue — decorate an async test function.

    Environment variables still win for seed/count/jobs unless explicitly
    overridden, so a failing seed printed by a CI run can be replayed with
    ``MADSIM_TEST_SEED=... pytest ...``.
    """

    def deco(f: AsyncFn) -> Callable[..., Any]:
        @functools.wraps(f)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            env_seed = _env_int("MADSIM_TEST_SEED")
            b = Builder.from_env(
                seed=env_seed if env_seed is not None else seed,
                count=count,
                jobs=jobs,
                procs=procs,
                config=config,
                time_limit=time_limit,
                check_determinism=check_determinism,
                allow_system_thread=allow_system_thread,
            )
            return b.run(lambda: f(*args, **kwargs))

        return wrapper

    if fn is not None:
        return deco(fn)
    return deco


def main(fn: AsyncFn) -> Callable[..., Any]:
    """``#[madsim::main]`` analogue."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        return Builder.from_env().run(lambda: fn(*args, **kwargs))

    return wrapper
