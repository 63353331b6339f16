"""Deterministic single-threaded task scheduler with nodes-as-processes.

Mirrors the reference's ``sim/task/`` (madsim/src/sim/task/mod.rs:43-1102):

- **Random-order ready queue**: the executor pops a *uniformly random* element
  from the ready queue each step — the source of schedule randomization
  (ref: sim/utils/mpsc.rs:71-84 ``try_recv_random`` swap_remove).
- **Hot loop** (``Executor::block_on``, task/mod.rs:220-260): drain ready
  queue in random order, poll each task, advance the clock a random 50-100 ns
  per poll (task/mod.rs:312-315), then jump the clock to the next timer event;
  raise the deadlock error when no events remain (task/mod.rs:250).
- **Node model** (task/mod.rs:87-176): a node = simulated process owning a set
  of tasks; kill wakes all tasks so the executor drops their coroutines
  (running ``finally`` blocks — the RAII analogue); restart re-runs the
  node's ``init`` closure on a fresh NodeInfo; pause parks popped tasks.
- **Restart-on-panic** (task/mod.rs:282-309): a panicking task on a flagged
  node kills the node and schedules a restart after a random 1-10 s backoff,
  optionally filtered by panic message.
"""

from __future__ import annotations

from typing import Any, Callable, Coroutine, Dict, List, NewType, Optional

from . import context
from .futures import CancelledError, JoinHandle
from .rand import GlobalRng
from .time import TimeHandle

NodeId = NewType("NodeId", int)

MAIN_NODE_ID = NodeId(0)


class DeadlockError(RuntimeError):
    """No timers pending and every task is blocked (ref task/mod.rs:250)."""


class TimeLimitError(RuntimeError):
    """Virtual time exceeded the configured limit (ref task/mod.rs:253-258)."""


class _TaskExit(BaseException):
    """Control-flow signal for simulated process exit (Spawner::exit)."""


class Task:
    """A spawned coroutine bound to a node (ref ``TaskInfo``/``Runnable``)."""

    __slots__ = (
        "id",
        "node",
        "coro",
        "join",
        "name",
        "spawn_site",
        "scheduled",
        "cancelled",
        "finished",
        "_executor",
        "_ready_items",  # direct list ref for the default queue (fast wake)
    )

    def __init__(
        self,
        executor: "Executor",
        node: "NodeInfo",
        coro: Coroutine[Any, Any, Any],
        name: Optional[str],
        spawn_site: str,
    ):
        self.id = executor._alloc_task_id()
        self.node = node
        self.coro = coro
        self.join = JoinHandle(self)
        self.name = name
        self.spawn_site = spawn_site
        self.scheduled = False
        self.cancelled = False
        self.finished = False
        self._executor = executor
        ready = executor.ready
        self._ready_items = ready._items if type(ready) is _PyReadyQueue else None

    def wake(self) -> None:
        """Enqueue this task for polling (idempotent while scheduled)."""
        if self.finished or self.scheduled:
            return
        self.scheduled = True
        items = self._ready_items
        if items is not None:
            items.append(self)  # default queue: skip two method dispatches
        else:
            self._executor.ready.append(self)

    def abort(self) -> None:
        """tokio ``AbortHandle::abort`` — mark cancelled and wake so the
        executor drops the coroutine."""
        if not self.finished:
            self.cancelled = True
            self.wake()

    def __repr__(self) -> str:
        return f"<Task {self.id} {self.name or ''} node={self.node.id}>"


class NodeInfo:
    """A simulated process (ref ``NodeInfo``, task/mod.rs:87-176)."""

    def __init__(
        self,
        id: NodeId,
        name: str,
        cores: int = 1,
        init: Optional[Callable[[], Coroutine[Any, Any, Any]]] = None,
        restart_on_panic: bool = False,
        restart_on_panic_matching: Optional[List[str]] = None,
    ):
        self.id = id
        self.name = name
        self.cores = cores
        self.init = init
        self.restart_on_panic = restart_on_panic
        self.restart_on_panic_matching = restart_on_panic_matching
        self.killed = False
        self.paused = False
        self.paused_tasks: List[Task] = []
        self.tasks: Dict[int, Task] = {}
        # ctrl-c handling (ref task/mod.rs:106-111,166-175,419-434)
        self.ctrl_c_installed = False
        self.ctrl_c_waiters: List[Any] = []

    def kill(self) -> None:
        """Mark killed and wake every task so the executor drops it
        (ref ``NodeInfo::kill``, task/mod.rs:133-140)."""
        self.killed = True
        self.paused = False
        parked, self.paused_tasks = self.paused_tasks, []
        for t in parked:
            t.scheduled = False
            t.wake()
        for t in list(self.tasks.values()):
            t.wake()

    def __repr__(self) -> str:
        return f"<Node {self.id} {self.name!r}>"


class _PyReadyQueue:
    """Default ready queue: Python list with swap-remove pops."""

    __slots__ = ("_items",)

    def __init__(self) -> None:
        self._items: List[Task] = []

    def append(self, task: "Task") -> None:
        self._items.append(task)

    def swap_remove(self, idx: int) -> "Task":
        items = self._items
        task = items[idx]
        items[idx] = items[-1]
        items.pop()
        return task

    def __len__(self) -> int:
        return len(self._items)


class _NativeReadyQueue:
    """C++ swap-remove queue (native.ReadyQueue); pop indices
    still come from the Python GlobalRng, so schedules are identical."""

    __slots__ = ("_q", "_tasks")

    def __init__(self) -> None:
        from .native import ReadyQueue

        self._q = ReadyQueue()
        self._tasks: Dict[int, Task] = {}

    def append(self, task: "Task") -> None:
        self._tasks[task.id] = task
        self._q.push(task.id)

    def swap_remove(self, idx: int) -> "Task":
        return self._tasks.pop(self._q.swap_remove(idx))

    def __len__(self) -> int:
        return len(self._q)


def _make_ready_queue():
    import os

    if os.environ.get("MADSIM_NATIVE"):
        from . import native

        if native.available():
            return _NativeReadyQueue()
    return _PyReadyQueue()


class Executor:
    """The deterministic event loop (ref ``Executor``, task/mod.rs:43-317)."""

    def __init__(self, rng: GlobalRng, time: TimeHandle):
        self.rng = rng
        self.time = time
        self.ready = _make_ready_queue()
        # compiled ready-loop driver (native/simloop.c) — available when
        # the time core is compiled and the default Python queue is in use
        self._cloop = None
        core = getattr(time, "_core", None)
        if core is not None and type(self.ready) is _PyReadyQueue:
            from . import native as _native

            sl = _native.simloop()
            if sl is not None:
                self._cloop = sl.Loop(
                    self, self.ready._items, rng, core, context._tls
                )
        self.nodes: Dict[NodeId, NodeInfo] = {}
        self._next_node_id = 1
        self._next_task_id = 1
        self.time_limit_ns: Optional[int] = None
        # set by Handle: called with node_id on kill/restart so registered
        # simulators reset per-node state (ref task/mod.rs:361-364)
        self.reset_node_hook: Callable[[NodeId], None] = lambda _id: None
        self.main_node = NodeInfo(MAIN_NODE_ID, "main")
        self.nodes[MAIN_NODE_ID] = self.main_node

    # -- ids ---------------------------------------------------------------

    def _alloc_task_id(self) -> int:
        tid = self._next_task_id
        self._next_task_id += 1
        return tid

    def alloc_node_id(self) -> NodeId:
        nid = NodeId(self._next_node_id)
        self._next_node_id += 1
        return nid

    # -- spawning ----------------------------------------------------------

    def spawn_on(
        self,
        node: NodeInfo,
        coro: Coroutine[Any, Any, Any],
        name: Optional[str] = None,
        spawn_site: str = "?",
    ) -> JoinHandle:
        """Spawn a coroutine as a task on ``node`` (ref ``Spawner::spawn``,
        task/mod.rs:575-655; raises on killed node, task/mod.rs:625-627)."""
        if node.killed:
            coro.close()
            raise RuntimeError(f"cannot spawn task: node {node} has been killed")
        task = Task(self, node, coro, name, spawn_site)
        node.tasks[task.id] = task
        task.wake()
        return task.join

    # -- the hot loop ------------------------------------------------------

    def block_on(self, coro: Coroutine[Any, Any, Any]) -> Any:
        """Run ``coro`` as the main task until completion
        (ref ``Executor::block_on``, task/mod.rs:220-260)."""
        main = self.spawn_on(self.main_node, coro, name="main", spawn_site="main")
        if self._cloop is not None:
            # the whole inner loop is compiled (ref task/mod.rs:220-260);
            # it re-reads self.time_limit_ns each iteration and raises via
            # _raise_time_limit, so mid-sim set_time_limit behaves exactly
            # like the Python loop below
            return self._cloop.run(main, DeadlockError, 50)
        while True:
            self.run_all_ready()
            if main.done():
                return main.result()
            if not self.time.advance_to_next_event():
                raise DeadlockError(
                    "deadlock detected: no timers are pending and every task "
                    "is blocked — the simulation can never make progress"
                )
            if (
                self.time_limit_ns is not None
                and self.time.now_ns > self.time_limit_ns
            ):
                raise TimeLimitError(
                    f"simulated time limit exceeded "
                    f"({self.time_limit_ns / 1e9:.3f}s of virtual time)"
                )

    def run_all_ready(self) -> None:
        """Drain the ready queue in random order
        (ref ``run_all_ready``, task/mod.rs:263-316).

        The Python-queue fast path inlines swap_remove and the 50-100 ns
        jitter advance; pop indices and jitter still come from the same
        GlobalRng draws in the same order, so schedules are byte-identical
        with the method-dispatch path (and with MADSIM_NATIVE)."""
        ready = self.ready
        rng_next = self.rng.next_u64
        time = self.time
        items = ready._items if type(ready) is _PyReadyQueue else None
        if items is None:
            self._run_all_ready_generic()
            return
        while items:
            n = len(items)
            # random swap-remove pop (ref sim/utils/mpsc.rs:73-83);
            # inlined gen_range(0, n) — Lemire reduction
            idx = rng_next() * n >> 64
            task = items[idx]
            items[idx] = items[-1]
            items.pop()
            task.scheduled = False
            if task.finished:
                continue
            node = task.node
            if task.cancelled or node.killed:
                self._drop_task(task)
                continue
            if node.paused:
                # park until resume (ref task/mod.rs:271-276)
                node.paused_tasks.append(task)
                continue
            self._poll(task)
            # random 50-100 ns advance per poll (ref task/mod.rs:312-315);
            # inlined gen_range(50, 101)
            time.advance_ns(50 + (rng_next() * 51 >> 64))

    def _run_all_ready_generic(self) -> None:
        """Method-dispatch drain for non-default queue backends
        (MADSIM_NATIVE) — same draws, same order as the fast path."""
        ready = self.ready
        rng = self.rng
        while len(ready):
            idx = rng.gen_range(0, len(ready))
            task = ready.swap_remove(idx)
            task.scheduled = False
            if task.finished:
                continue
            node = task.node
            if task.cancelled or node.killed:
                self._drop_task(task)
                continue
            if node.paused:
                node.paused_tasks.append(task)
                continue
            self._poll(task)
            self.time.advance_ns(rng.gen_range(50, 101))

    def _poll(self, task: Task) -> None:
        prev = context.swap_task(task)
        try:
            pollable = task.coro.send(None)
        except StopIteration as stop:
            self._finish(task)
            task.join.set_result(stop.value)
            return
        except _TaskExit:
            self._finish(task)
            task.join.set_result(None)
            return
        except Exception as exc:  # noqa: BLE001 — the catch_unwind analogue
            self._finish(task)
            self._on_panic(task, exc)
            return
        finally:
            context.swap_task(prev)
        pollable.subscribe(task)

    def _finish(self, task: Task) -> None:
        task.finished = True
        task.node.tasks.pop(task.id, None)

    # -- callbacks for the compiled loop (native/simloop.c) ---------------

    def _complete(self, task: Task, value: Any) -> None:
        """Task coroutine returned ``value`` (the StopIteration branch)."""
        self._finish(task)
        task.join.set_result(value)

    def _raise_time_limit(self) -> None:
        """Raise the TimeLimitError the Python loop would (called by the
        compiled loop when the clock passes ``time_limit_ns``)."""
        raise TimeLimitError(
            f"simulated time limit exceeded "
            f"({self.time_limit_ns / 1e9:.3f}s of virtual time)"
        )

    def _poll_raised(self, task: Task, exc: BaseException) -> bool:
        """Exception out of a poll; returns False to propagate (the
        KeyboardInterrupt/SystemExit path, mirroring ``except Exception``)."""
        if isinstance(exc, _TaskExit):
            self._finish(task)
            task.join.set_result(None)
            return True
        if isinstance(exc, Exception):
            self._finish(task)
            self._on_panic(task, exc)
            return True
        return False

    def _drop_task(self, task: Task) -> None:
        """Drop a cancelled/killed task's coroutine, running its ``finally``
        blocks (the RAII analogue: e.g. BindGuard releases ports)."""
        task.finished = True
        task.node.tasks.pop(task.id, None)
        with context.enter_task(task):
            try:
                task.coro.close()
            except Exception:  # noqa: BLE001 — cleanup must not kill the sim
                pass
        task.join.set_exception(CancelledError(f"{task!r} was cancelled"))

    def _on_panic(self, task: Task, exc: Exception) -> None:
        """ref task/mod.rs:282-309: restart-on-panic or propagate."""
        node = task.node
        matching = node.restart_on_panic_matching
        should_restart = node.restart_on_panic and (
            matching is None or any(pat in str(exc) for pat in matching)
        )
        if should_restart and node.id != MAIN_NODE_ID:
            task.join.set_exception(exc)
            self.kill(node.id)
            # random 1-10 s restart backoff (ref task/mod.rs:291-307)
            delay_ns = self.rng.gen_range(1_000_000_000, 10_000_000_001)
            node_id = node.id
            self.time.add_timer_ns(delay_ns, lambda: self.restart(node_id))
            return
        task.join.set_exception(exc)
        # propagate: abort the whole simulation (resume_unwind analogue)
        raise exc

    # -- node lifecycle (ref TaskHandle, task/mod.rs:347-535) --------------

    def create_node(
        self,
        name: Optional[str] = None,
        cores: int = 1,
        init: Optional[Callable[[], Coroutine[Any, Any, Any]]] = None,
        restart_on_panic: bool = False,
        restart_on_panic_matching: Optional[List[str]] = None,
    ) -> NodeInfo:
        nid = self.alloc_node_id()
        node = NodeInfo(
            nid,
            name if name is not None else f"node-{nid}",
            cores=cores,
            init=init,
            restart_on_panic=restart_on_panic,
            restart_on_panic_matching=restart_on_panic_matching,
        )
        self.nodes[nid] = node
        return node

    def get_node(self, id: NodeId) -> Optional[NodeInfo]:
        return self.nodes.get(id)

    def _node(self, id: NodeId) -> NodeInfo:
        node = self.nodes.get(id)
        if node is None:
            raise KeyError(f"no such node: {id}")
        return node

    def kill(self, id: NodeId) -> None:
        """ref ``TaskHandle::kill_id`` (task/mod.rs:355-364)."""
        node = self._node(id)
        node.kill()
        self.reset_node_hook(id)

    def restart(self, id: NodeId) -> None:
        """Kill then respawn the node's ``init`` closure on a fresh NodeInfo
        (ref task/mod.rs:367-394)."""
        old = self._node(id)
        old.kill()
        self.reset_node_hook(id)
        new = NodeInfo(
            id,
            old.name,
            cores=old.cores,
            init=old.init,
            restart_on_panic=old.restart_on_panic,
            restart_on_panic_matching=old.restart_on_panic_matching,
        )
        self.nodes[id] = new
        if new.init is not None:
            self.spawn_on(new, new.init(), name="init", spawn_site="init")

    def pause(self, id: NodeId) -> None:
        self._node(id).paused = True

    def resume(self, id: NodeId) -> None:
        node = self._node(id)
        node.paused = False
        parked, node.paused_tasks = node.paused_tasks, []
        for t in parked:
            t.wake()

    def send_ctrl_c(self, id: NodeId) -> None:
        """Notify ctrl-c subscribers, or kill if none installed
        (ref task/mod.rs:419-434)."""
        node = self._node(id)
        if node.ctrl_c_installed:
            waiters, node.ctrl_c_waiters = node.ctrl_c_waiters, []
            for fut in waiters:
                fut.set_result(None)
        else:
            self.kill(id)

    def is_exit(self, id: NodeId) -> bool:
        node = self.nodes.get(id)
        return node is None or node.killed

    # -- metrics (ref task/mod.rs:490-534) ---------------------------------

    def num_tasks(self) -> int:
        return sum(len(n.tasks) for n in self.nodes.values())

    def num_tasks_by_node(self) -> Dict[str, int]:
        return {n.name: len(n.tasks) for n in self.nodes.values() if n.tasks}

    def num_tasks_by_spawn_site(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes.values():
            for t in n.tasks.values():
                out[t.spawn_site] = out.get(t.spawn_site, 0) + 1
        return out


# -- ambient spawning API (task::spawn) ------------------------------------


def _spawn_site(depth: int = 2) -> str:
    import sys

    try:
        frame = sys._getframe(depth)
        return f"{frame.f_code.co_filename}:{frame.f_lineno}"
    except ValueError:
        return "?"


def spawn(coro: Coroutine[Any, Any, Any], name: Optional[str] = None) -> JoinHandle:
    """Spawn a task on the current node (ref ``task::spawn``)."""
    task = context.current_task()
    return task._executor.spawn_on(task.node, coro, name=name, spawn_site=_spawn_site())


def spawn_local(
    coro: Coroutine[Any, Any, Any], name: Optional[str] = None
) -> JoinHandle:
    """Alias of :func:`spawn` — the simulator is single-threaded by design."""
    task = context.current_task()
    return task._executor.spawn_on(task.node, coro, name=name, spawn_site=_spawn_site())


def exit_current_task() -> None:
    """Simulated ``process::exit`` for the current node (Spawner::exit):
    kills the node and unwinds the current task immediately."""
    task = context.current_task()
    task._executor.kill(task.node.id)
    raise _TaskExit()
