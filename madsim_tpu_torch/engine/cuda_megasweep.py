"""The megasweep kernel's wrapper: its planes, its launch and its build.

``csrc/megasweep.cu`` (built for ``sm_90a`` with ``nvcc`` at first use by
``cuda_build``, bound with ``ctypes``) updates a probe-workload state in
place. ``planes(state)`` makes the contiguous copies it updates — the
uint32 key as int64 words and the bool leaves as uint8, because CUDA
torch has no uint32 kernels and the C interface wants plain bytes —
``launch`` runs ``steps`` events for every seed of the planes, and
``to_state`` builds the new ``EngineState`` with the state's own dtypes.
``pointers`` lists the planes' addresses in the C entry point's order
(the CPU tests hand the same planes to the kernel's event function built
for the host). ``megakernel.run_megasweep`` drives these and counts the
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from . import cuda_build
from .core import EngineState
from .queue import EventQueue

PAYLOAD_SLOTS = 8
RING = (5, 32)
MAX_CAPACITY = 64  # the bits of a seed's live mask

_ORDER = ("qtime", "qkind", "qpay", "key", "now", "ctr", "done", "ov",
          "qmax", "ring", "acc", "nsent")


def build() -> ctypes.CDLL:
    """Compile ``csrc/megasweep.cu`` (unless an identical build exists) and
    load it; ``cuda_build.LOGS["megasweep"]`` keeps the compiler's output."""
    return cuda_build.build(
        "megasweep", "madsim_megasweep",
        [ctypes.c_void_p] * 12
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_void_p],
    )


def planes(state: EngineState) -> Dict[str, torch.Tensor]:
    """Contiguous copies of the leaves the kernel reads and writes,
    checked against what it takes."""
    q = state.queue
    s, cap = q.time.shape
    w = state.wstate
    if type(q) is not EventQueue:
        raise ValueError("megasweep kernel takes the EventQueue layout (no valid plane)")
    if not 1 <= cap <= MAX_CAPACITY:
        raise ValueError(f"megasweep kernel takes 1 <= Q <= {MAX_CAPACITY}, got {cap}")
    if tuple(q.pay.shape[1:]) != (cap, PAYLOAD_SLOTS):
        raise ValueError(
            f"megasweep kernel takes {PAYLOAD_SLOTS} payload slots, got "
            f"pay {tuple(q.pay.shape)}"
        )
    if not hasattr(w, "ring") or tuple(w.ring.shape[1:]) != RING:
        raise ValueError("megasweep kernel runs the probe workload's state only")
    p = {
        "qtime": q.time, "qkind": q.kind, "qpay": q.pay,
        "key": state.key.to(torch.int64), "now": state.now_ns, "ctr": state.ctr,
        "done": state.done.to(torch.uint8), "ov": state.overflow.to(torch.uint8),
        "qmax": state.qmax, "ring": w.ring, "acc": w.acc, "nsent": w.nsent,
    }
    want = {"qtime": torch.int64, "qkind": torch.int32, "qpay": torch.int32,
            "now": torch.int64, "ctr": torch.int32, "qmax": torch.int64,
            "ring": torch.int32, "acc": torch.int32, "nsent": torch.int32}
    for name, dtype in want.items():
        if p[name].dtype != dtype:
            raise ValueError(f"megasweep kernel: {name} must be {dtype}, got {p[name].dtype}")
    for name, t in p.items():
        if t.device != q.time.device or t.shape[0] != s:
            raise ValueError(f"megasweep kernel: {name} is not a [S={s}] plane on {q.time.device}")
    # private copies: the kernel writes in place, the caller's state stays
    return {k: t.contiguous().clone() for k, t in p.items()}


def pointers(p: Dict[str, torch.Tensor]) -> List[int]:
    """The planes' addresses in the C entry point's argument order."""
    return [p[k].data_ptr() for k in _ORDER]


def launch(p: Dict[str, torch.Tensor], steps: int, time_limit: int) -> None:
    """One kernel launch: ``steps`` events for every seed of the planes."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if not -(1 << 63) <= time_limit < 1 << 63:
        raise ValueError(f"time_limit {time_limit} is not an int64")
    qtime = p["qtime"]
    rc = build().madsim_megasweep(
        *pointers(p), qtime.shape[0], qtime.shape[1], steps, time_limit,
        torch.cuda.current_stream(qtime.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"megasweep kernel launch failed: error {rc}")


def to_state(state: EngineState, p: Dict[str, torch.Tensor]) -> EngineState:
    """The state after the kernel: its planes in the state's dtypes; the
    leaves the probe workload never touches (coverage, history, event
    mix, width 0 here) pass through."""
    return state._replace(
        now_ns=p["now"],
        ctr=p["ctr"],
        done=p["done"].to(torch.bool),
        overflow=p["ov"].to(torch.bool),
        qmax=p["qmax"],
        queue=EventQueue(time=p["qtime"], kind=p["qkind"], pay=p["qpay"]),
        wstate=state.wstate._replace(ring=p["ring"], acc=p["acc"], nsent=p["nsent"]),
    )
