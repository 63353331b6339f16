"""Python-level interposition of stdlib nondeterminism sources.

The reference interposes at the libc boundary with ``#[no_mangle]`` symbol
overrides: ``getrandom``/``getentropy`` route into GlobalRng
(madsim/src/sim/rand.rs:197-260), ``clock_gettime``/``gettimeofday`` return
sim time (sim/time/system_time.rs:4-113), and ``pthread_attr_init`` blocks
thread creation unless ``MADSIM_ALLOW_SYSTEM_THREAD`` is set
(sim/task/mod.rs:707-785).

The Python analogue patches the stdlib entry points **once**, with dispatching
wrappers that check the ambient sim context per call: inside a simulation they
produce deterministic values from the runtime's GlobalRng / virtual clock;
outside they fall through to the real implementation.  This makes the patch
safe under concurrent seed-sweep threads (each thread has its own ambient
handle) — the same property the reference gets from thread-local context.

Intercepted:  ``random.*`` (module-level functions), ``os.urandom``,
``uuid.uuid4``, ``time.{time,time_ns,monotonic,monotonic_ns,perf_counter,
perf_counter_ns}``, ``threading.Thread.start`` (blocked in sim unless
allowed), ``os.cpu_count`` (reports the node's configured cores), and
``datetime.datetime`` / ``datetime.date`` (module attributes swapped for
sim-aware subclasses whose ``now``/``utcnow``/``today`` read the virtual
clock; the C methods themselves are unpatchable).  Pre-existing aliases
— code that ran ``from datetime import datetime`` *before* the sim
started — are rebound by scanning every loaded module's dict for
attributes holding the real classes (freezegun's approach) and restored
on uninstall; the remaining (documented) hole is non-module references
captured before install, e.g. a class attribute or closure cell holding
the real class.  Sim-aware ``datetime.now()`` returns UTC-based naive
time so results don't depend on the host machine's timezone database.
"""

from __future__ import annotations

import os
import threading
import uuid as _uuid_mod
from contextlib import contextmanager
from typing import Any, Iterator

from .context import try_current_handle

_lock = threading.Lock()
_install_count = 0
_originals: dict = {}
# (module, attr, real_class) triples rebound by the alias scan, for restore
_rebound_aliases: list = []
# alias-scan memo: module name -> id() at last scan, and the discovered
# (attr, kind) sites per module — repeat installs only rescan modules
# that appeared (or were reloaded) since, instead of every attribute of
# every module (measured ~3 ms/scan; installs happen per block_on)
# name -> module (weak): compared by identity against the LIVE object, so a
# re-imported module whose object happens to reuse a freed id is re-scanned
# instead of silently skipped
import weakref as _weakref

_scanned_mods: "_weakref.WeakValueDictionary" = _weakref.WeakValueDictionary()
_alias_sites: dict = {}


class _SimRandomDispatch:
    """random-module replacement functions backed by the ambient GlobalRng."""

    @staticmethod
    def random() -> float:
        h = try_current_handle()
        if h is None:
            return _originals["random.random"]()
        return h.rng.random()

    @staticmethod
    def getrandbits(k: int) -> int:
        h = try_current_handle()
        if h is None:
            return _originals["random.getrandbits"](k)
        out = 0
        bits = 0
        while bits < k:
            out |= h.rng.next_u64() << bits
            bits += 64
        return out & ((1 << k) - 1)

    @staticmethod
    def randbytes(n: int) -> bytes:
        h = try_current_handle()
        if h is None:
            return _originals["random.randbytes"](n)
        return h.rng.sample_bytes(n)

    @staticmethod
    def randrange(start: int, stop: Any = None, step: int = 1) -> int:
        h = try_current_handle()
        if h is None:
            return _originals["random.randrange"](start, stop, step)
        if stop is None:
            start, stop = 0, start
        width = (stop - start + step - 1) // step if step > 0 else None
        if width is None or width <= 0:
            raise ValueError("empty range for randrange")
        return start + step * h.rng.gen_range(0, width)

    @staticmethod
    def randint(a: int, b: int) -> int:
        h = try_current_handle()
        if h is None:
            return _originals["random.randint"](a, b)
        return h.rng.gen_range(a, b + 1)

    @staticmethod
    def uniform(a: float, b: float) -> float:
        h = try_current_handle()
        if h is None:
            return _originals["random.uniform"](a, b)
        return h.rng.uniform(a, b)

    @staticmethod
    def choice(seq: Any) -> Any:
        h = try_current_handle()
        if h is None:
            return _originals["random.choice"](seq)
        return h.rng.choice(seq)

    @staticmethod
    def shuffle(seq: Any) -> None:
        h = try_current_handle()
        if h is None:
            return _originals["random.shuffle"](seq)
        return h.rng.shuffle(seq)


def _sim_urandom(n: int) -> bytes:
    h = try_current_handle()
    if h is None:
        return _originals["os.urandom"](n)
    return h.rng.sample_bytes(n)


def _sim_uuid4() -> "_uuid_mod.UUID":
    h = try_current_handle()
    if h is None:
        return _originals["uuid.uuid4"]()
    return _uuid_mod.UUID(bytes=h.rng.sample_bytes(16), version=4)


def _make_clock(name: str, kind: str, ns: bool):
    def clock() -> Any:
        h = try_current_handle()
        if h is None:
            return _originals[name]()
        t = h.time.now_time_ns() if kind == "wall" else h.time.now_ns
        return t if ns else t / 1e9

    clock.__name__ = name.split(".")[-1]
    return clock


def _sim_thread_start(self: threading.Thread, *args: Any, **kwargs: Any) -> Any:
    h = try_current_handle()
    if h is not None and not getattr(h, "allow_system_thread", False):
        raise RuntimeError(
            "attempted to spawn an OS thread inside a deterministic "
            "simulation; real threads break determinism. Use "
            "madsim_tpu_torch.spawn() for concurrency, or set "
            "MADSIM_ALLOW_SYSTEM_THREAD=1 if you know what you are doing "
            "(ref: madsim blocks pthread creation, sim/task/mod.rs:761-785)"
        )
    return _originals["threading.Thread.start"](self, *args, **kwargs)


def _make_datetime_classes():
    """Sim-aware ``datetime``/``date`` subclasses (built lazily at install
    so the saved originals are whatever the process currently has).

    The reference fixes this whole class of leak at the libc boundary —
    ``clock_gettime``/``gettimeofday`` overrides (sim/time/system_time.rs:
    4-113) — which Python cannot do; swapping the module attributes is the
    closest interposition point above the C layer.
    """
    import datetime as _dt

    real_datetime = _originals["datetime.datetime"]
    real_date = _originals["datetime.date"]

    # isinstance/issubclass against the swapped classes must behave exactly
    # like checks against the real ones (freezegun-style): a real datetime
    # created before the swap is an instance of SimDateTime, and
    # SimDateTime.now() is an instance of SimDate (datetime ⊂ date holds).
    # Without this, serializer-style `isinstance(x, datetime.date)` dispatch
    # would take different branches inside vs outside the sim.
    def _delegating_meta(real_cls):
        class _Meta(type):
            def __instancecheck__(cls, obj):
                return isinstance(obj, real_cls)

            def __subclasscheck__(cls, sub):
                return issubclass(sub, real_cls)

        return _Meta

    class SimDateTime(
        real_datetime, metaclass=_delegating_meta(real_datetime)
    ):  # type: ignore[valid-type, misc]
        @classmethod
        def now(cls, tz=None):
            h = try_current_handle()
            if h is None:
                return real_datetime.now(tz)
            ts = h.time.now_time_ns() / 1e9
            if tz is not None:
                return cls.fromtimestamp(ts, tz)
            # UTC-based naive: local-tz conversion would make the same seed
            # produce different datetimes on differently-configured hosts
            return cls.fromtimestamp(ts, _dt.timezone.utc).replace(tzinfo=None)

        @classmethod
        def utcnow(cls):
            h = try_current_handle()
            if h is None:
                return real_datetime.utcnow()
            ts = h.time.now_time_ns() / 1e9
            return cls.fromtimestamp(ts, _dt.timezone.utc).replace(tzinfo=None)

        @classmethod
        def today(cls):
            return cls.now()

    class SimDate(
        real_date, metaclass=_delegating_meta(real_date)
    ):  # type: ignore[valid-type, misc]
        @classmethod
        def today(cls):
            h = try_current_handle()
            if h is None:
                return real_date.today()
            d = SimDateTime.now()
            return cls(d.year, d.month, d.day)

    return SimDateTime, SimDate


def _rebind_datetime_aliases(sim_datetime, sim_date) -> None:
    """Close the pre-import alias hole: rebind every loaded module's
    attributes that hold the REAL ``datetime``/``date`` classes (bound by
    ``from datetime import datetime`` before the sim started) to the
    sim-aware subclasses, recording each for restore at uninstall.

    freezegun's module-scan approach; the libc interposition it stands in
    for (sim/time/system_time.rs:4-113) has no such hole because it
    patches below the class, at ``clock_gettime``. Residual (documented)
    gaps: non-module references captured pre-install (class attributes,
    closure cells), and attributes *assigned into an already-imported
    module's dict* between sims — the memo below rescans a module only
    when it first appears in (or is reloaded into) ``sys.modules``,
    which covers the real flow (``from datetime import datetime`` runs
    at module import)."""
    import sys

    real_datetime = _originals["datetime.datetime"]
    real_date = _originals["datetime.date"]
    real_by_kind = {"datetime": real_datetime, "date": real_date}
    sim_by_kind = {"datetime": sim_datetime, "date": sim_date}

    # pass 1: discover sites in modules not seen (or reloaded) since the
    # last scan; already-scanned modules are skipped entirely
    for name, mod in list(sys.modules.items()):
        if mod is None or name in ("datetime", __name__):
            continue
        if _scanned_mods.get(name) is mod:
            continue
        sites = []
        try:
            items = list(vars(mod).items())
        except Exception:
            items = []  # lazy-loader modules may raise on dict access
        for attr, val in items:
            if val is real_datetime:
                sites.append((attr, "datetime"))
            elif val is real_date:
                sites.append((attr, "date"))
        try:
            _scanned_mods[name] = mod
        except TypeError:
            pass  # non-weakref-able module-like object: rescan next time
        if sites:
            _alias_sites[name] = sites
        else:
            _alias_sites.pop(name, None)

    # pass 2: rebind every known site that still holds the real class
    for name, sites in list(_alias_sites.items()):
        mod = sys.modules.get(name)
        if mod is None:
            continue
        for attr, kind in sites:
            try:
                if getattr(mod, attr, None) is real_by_kind[kind]:
                    setattr(mod, attr, sim_by_kind[kind])
                    _rebound_aliases.append((mod, attr, real_by_kind[kind]))
            except Exception:
                continue  # read-only module attribute; leave it


def _restore_datetime_aliases() -> None:
    for mod, attr, real_cls in _rebound_aliases:
        try:
            setattr(mod, attr, real_cls)
        except Exception:
            pass
    _rebound_aliases.clear()


def _sim_cpu_count() -> Any:
    """Inside a sim task, report the node's configured cores — the
    analogue of the reference faking ``available_parallelism`` via
    ``sched_getaffinity``/``sysconf`` (task/mod.rs:707-760)."""
    from . import context

    task = context.try_current_task()
    if task is None:
        return _originals["os.cpu_count"]()
    return task.node.cores


def _install() -> None:
    import datetime as _dt
    import random as _r
    import time as _t

    _originals.update(
        {
            "datetime.datetime": _dt.datetime,
            "datetime.date": _dt.date,
        }
    )
    _originals.update(
        {
            "random.random": _r.random,
            "random.getrandbits": _r.getrandbits,
            "random.randbytes": _r.randbytes,
            "random.randrange": _r.randrange,
            "random.randint": _r.randint,
            "random.uniform": _r.uniform,
            "random.choice": _r.choice,
            "random.shuffle": _r.shuffle,
            "os.urandom": os.urandom,
            "uuid.uuid4": _uuid_mod.uuid4,
            "time.time": _t.time,
            "time.time_ns": _t.time_ns,
            "time.monotonic": _t.monotonic,
            "time.monotonic_ns": _t.monotonic_ns,
            "time.perf_counter": _t.perf_counter,
            "time.perf_counter_ns": _t.perf_counter_ns,
            "threading.Thread.start": threading.Thread.start,
            "os.cpu_count": os.cpu_count,
        }
    )
    os.cpu_count = _sim_cpu_count
    _r.random = _SimRandomDispatch.random
    _r.getrandbits = _SimRandomDispatch.getrandbits
    _r.randbytes = _SimRandomDispatch.randbytes
    _r.randrange = _SimRandomDispatch.randrange
    _r.randint = _SimRandomDispatch.randint
    _r.uniform = _SimRandomDispatch.uniform
    _r.choice = _SimRandomDispatch.choice
    _r.shuffle = _SimRandomDispatch.shuffle
    os.urandom = _sim_urandom
    _uuid_mod.uuid4 = _sim_uuid4
    _t.time = _make_clock("time.time", "wall", ns=False)
    _t.time_ns = _make_clock("time.time_ns", "wall", ns=True)
    _t.monotonic = _make_clock("time.monotonic", "mono", ns=False)
    _t.monotonic_ns = _make_clock("time.monotonic_ns", "mono", ns=True)
    _t.perf_counter = _make_clock("time.perf_counter", "mono", ns=False)
    _t.perf_counter_ns = _make_clock("time.perf_counter_ns", "mono", ns=True)
    threading.Thread.start = _sim_thread_start  # type: ignore[method-assign]
    _dt.datetime, _dt.date = _make_datetime_classes()
    _rebind_datetime_aliases(_dt.datetime, _dt.date)


def _uninstall() -> None:
    import datetime as _dt
    import random as _r
    import time as _t

    _restore_datetime_aliases()
    _dt.datetime = _originals["datetime.datetime"]
    _dt.date = _originals["datetime.date"]

    _r.random = _originals["random.random"]
    _r.getrandbits = _originals["random.getrandbits"]
    _r.randbytes = _originals["random.randbytes"]
    _r.randrange = _originals["random.randrange"]
    _r.randint = _originals["random.randint"]
    _r.uniform = _originals["random.uniform"]
    _r.choice = _originals["random.choice"]
    _r.shuffle = _originals["random.shuffle"]
    os.urandom = _originals["os.urandom"]
    _uuid_mod.uuid4 = _originals["uuid.uuid4"]
    _t.time = _originals["time.time"]
    _t.time_ns = _originals["time.time_ns"]
    _t.monotonic = _originals["time.monotonic"]
    _t.monotonic_ns = _originals["time.monotonic_ns"]
    _t.perf_counter = _originals["time.perf_counter"]
    _t.perf_counter_ns = _originals["time.perf_counter_ns"]
    threading.Thread.start = _originals["threading.Thread.start"]
    os.cpu_count = _originals["os.cpu_count"]
    _originals.clear()


@contextmanager
def interposed(handle: Any, allow_system_thread: bool = False) -> Iterator[None]:
    """Enable stdlib interposition for the duration of a simulation run.

    Installation is global but refcounted and dispatch is per-thread via the
    ambient context, so concurrent seed-sweep threads are safe.
    """
    global _install_count
    handle.allow_system_thread = allow_system_thread
    with _lock:
        if _install_count == 0:
            _install()
        _install_count += 1
    try:
        yield
    finally:
        with _lock:
            _install_count -= 1
            if _install_count == 0:
                _uninstall()
