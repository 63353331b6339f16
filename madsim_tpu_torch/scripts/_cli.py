"""What the drivers share: ``--device`` and its refusal without a card,
the one JSON line on stdout, the stderr heartbeat read from the obs
registry, and the smokes' checks."""

from __future__ import annotations

import json
import os
import sys
import threading


def add_device(ap) -> None:
    """The device-tier drivers' ``--device`` flag (default: CUDA)."""
    ap.add_argument(
        "--device", default=None,
        help="torch device to run on (default cuda; there is no fallback to "
        "the CPU: pass --device cpu to run the plain torch path)",
    )


def device(args, prog: str):
    """``args.device`` resolved; without a card (and without an explicit
    CPU device) the driver exits with code 2, naming the reason."""
    from .. import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        raise SystemExit(2)


def check(ok: bool, what: str) -> None:
    """A failed contract: an ``AssertionError``, as the reference's
    ``assert`` gives, but also under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def device_name(dev) -> str:
    """The backend name a report carries (the reference prints
    ``jax.default_backend()``): ``cpu`` or ``cuda``."""
    return dev.type


def emit(obj, **kw) -> None:
    """The driver's one JSON line on stdout."""
    print(json.dumps(obj, **kw), flush=True)


def hb_seconds() -> float:
    """The heartbeat's cadence: ``MADSIM_HB_SECONDS`` (default 5; 0
    disables it)."""
    return float(os.environ.get("MADSIM_HB_SECONDS", 5.0))


def heartbeat(registry, total: int, prefix: str = "sweep"):
    """``(hb, stop)``: an ``obs.Heartbeat`` over ``registry`` ticked
    from a daemon thread every ``hb_seconds()`` (none when 0), and the
    function that stops the thread."""
    from .. import obs

    hb = obs.Heartbeat(registry, total, prefix=prefix)
    every = hb_seconds()
    if every <= 0:
        return hb, lambda: None
    stop = threading.Event()

    def beat():
        while not stop.wait(every):
            hb.tick()

    threading.Thread(target=beat, daemon=True, name="hb").start()
    return hb, stop.set

