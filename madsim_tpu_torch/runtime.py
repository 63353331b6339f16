"""Runtime shell: composition root + supervisor Handle + NodeBuilder.

Mirrors the reference's ``sim/runtime/`` (madsim/src/sim/runtime/mod.rs:34-449):
``Runtime`` wires rng + virtual time + executor + default simulators (FsSim,
NetSim — runtime/mod.rs:53-69); ``Handle`` is the supervisor façade (seed,
kill, restart, pause, resume, ctrl-c, create_node, metrics —
runtime/mod.rs:237-322); ``NodeBuilder`` configures name/ip/cores/init/
restart_on_panic (runtime/mod.rs:374-418); ``check_determinism`` runs a
workload twice recording/replaying the RNG log (runtime/mod.rs:178-202).
"""

from __future__ import annotations

import inspect
import logging
from typing import (
    Any,
    Callable,
    Coroutine,
    Dict,
    List,
    Optional,
    Type,
    TypeVar,
    Union,
)

import gc as _gc
import threading as _threading

from . import context
from .config import Config

# Relaxed gen-0 cycle-GC threshold while any sim runs: the executor
# allocates mostly-acyclic objects at event rate, and collection timing
# cannot affect schedules (no draws, no sim state), only wall-clock.
# Refcounted so concurrent block_on calls (the one-thread-per-seed sweep
# pattern) don't snapshot each other's raised threshold and leak it; the
# original is restored when the LAST sim exits. Threshold 0 (embedder
# disabled GC) is left alone.
_gc_lock = _threading.Lock()
_gc_depth = 0
_gc_saved: "tuple | None" = None


def _gc_relax() -> None:
    global _gc_depth, _gc_saved
    with _gc_lock:
        _gc_depth += 1
        if _gc_depth == 1:
            t = _gc.get_threshold()
            if t[0] > 0:
                _gc_saved = t
                _gc.set_threshold(max(t[0], 50_000), *t[1:])
            else:
                _gc_saved = None


def _gc_restore() -> None:
    global _gc_depth, _gc_saved
    with _gc_lock:
        _gc_depth -= 1
        if _gc_depth == 0 and _gc_saved is not None:
            _gc.set_threshold(*_gc_saved)
            _gc_saved = None
from .futures import JoinHandle
from .metrics import RuntimeMetrics
from .plugin import Simulator
from .rand import GlobalRng
from .task import Executor, NodeId, NodeInfo, MAIN_NODE_ID
from .time import TimeHandle, make_time_handle

S = TypeVar("S", bound=Simulator)

NodeRef = Union["NodeHandle", NodeInfo, NodeId, int]


def _node_id(node: NodeRef) -> NodeId:
    if isinstance(node, NodeHandle):
        return node.id
    if isinstance(node, NodeInfo):
        return node.id
    return NodeId(int(node))


class Handle:
    """Supervisor façade over a running simulation (runtime/mod.rs:237-322)."""

    def __init__(self, rng: GlobalRng, time: TimeHandle, executor: Executor,
                 config: Config):
        self.rng = rng
        self.time = time
        self.executor = executor
        self.config = config
        self.sims: Dict[Type[Simulator], Simulator] = {}
        executor.reset_node_hook = self._reset_node_sims

    @staticmethod
    def current() -> "Handle":
        return context.current_handle()

    @property
    def seed(self) -> int:
        return self.rng.seed

    # -- simulator registry (ref plugin.rs + runtime/mod.rs:72-83) ---------

    def add_simulator(self, cls: Type[S]) -> S:
        if cls in self.sims:
            return self.sims[cls]  # type: ignore[return-value]
        sim = cls(self.rng, self.time, self.config)
        self.sims[cls] = sim
        # late registration: tell the new simulator about existing nodes
        for nid in self.executor.nodes:
            sim.create_node(nid)
        return sim

    def simulator(self, cls: Type[S]) -> S:
        sim = self.sims.get(cls)
        if sim is None:
            raise KeyError(
                f"simulator {cls.__name__} is not registered on this runtime"
            )
        return sim  # type: ignore[return-value]

    def _reset_node_sims(self, id: NodeId) -> None:
        for sim in self.sims.values():
            sim.reset_node(id)

    # -- supervision (runtime/mod.rs:272-303) ------------------------------

    def kill(self, node: NodeRef) -> None:
        self.executor.kill(_node_id(node))

    def restart(self, node: NodeRef) -> None:
        self.executor.restart(_node_id(node))

    def pause(self, node: NodeRef) -> None:
        self.executor.pause(_node_id(node))

    def resume(self, node: NodeRef) -> None:
        self.executor.resume(_node_id(node))

    def send_ctrl_c(self, node: NodeRef) -> None:
        self.executor.send_ctrl_c(_node_id(node))

    def is_exit(self, node: NodeRef) -> bool:
        return self.executor.is_exit(_node_id(node))

    def create_node(self) -> "NodeBuilder":
        return NodeBuilder(self)

    def get_node(self, node: NodeRef) -> Optional["NodeHandle"]:
        info = self.executor.get_node(_node_id(node))
        return NodeHandle(self, info) if info is not None else None

    def metrics(self) -> RuntimeMetrics:
        return RuntimeMetrics(self.executor)


class NodeHandle:
    """Handle to a simulated node (ref ``NodeHandle``, runtime/mod.rs:389-418)."""

    def __init__(self, handle: Handle, info: NodeInfo):
        self._handle = handle
        self._info = info

    @property
    def id(self) -> NodeId:
        # resolve through the executor so a restarted node's fresh NodeInfo
        # is used for spawns
        return self._info.id

    @property
    def name(self) -> str:
        return self._info.name

    def spawn(self, coro: Coroutine[Any, Any, Any],
              name: Optional[str] = None) -> JoinHandle:
        info = self._handle.executor.get_node(self._info.id)
        if info is None:
            raise RuntimeError(f"node {self._info.id} no longer exists")
        return self._handle.executor.spawn_on(info, coro, name=name)

    def __repr__(self) -> str:
        return f"<NodeHandle {self.id} {self.name!r}>"


class NodeBuilder:
    """Builder for simulated nodes (ref runtime/mod.rs:374-418)."""

    def __init__(self, handle: Handle):
        self._handle = handle
        self._name: Optional[str] = None
        self._ip: Optional[str] = None
        self._cores: int = 1
        self._init: Optional[Callable[[], Coroutine[Any, Any, Any]]] = None
        self._restart_on_panic = False
        self._restart_on_panic_matching: Optional[List[str]] = None

    def name(self, name: str) -> "NodeBuilder":
        self._name = name
        return self

    def ip(self, ip: str) -> "NodeBuilder":
        self._ip = ip
        return self

    def cores(self, cores: int) -> "NodeBuilder":
        if cores < 1:
            raise ValueError("cores must be >= 1")
        self._cores = cores
        return self

    def init(self, f: Callable[[], Coroutine[Any, Any, Any]]) -> "NodeBuilder":
        """Async closure respawned on every (re)start (runtime/mod.rs:395)."""
        self._init = f
        return self

    def restart_on_panic(self, matching: Optional[str] = None) -> "NodeBuilder":
        self._restart_on_panic = True
        if matching is not None:
            pats = self._restart_on_panic_matching or []
            pats.append(matching)
            self._restart_on_panic_matching = pats
        return self

    def build(self) -> NodeHandle:
        ex = self._handle.executor
        info = ex.create_node(
            name=self._name,
            cores=self._cores,
            init=self._init,
            restart_on_panic=self._restart_on_panic,
            restart_on_panic_matching=self._restart_on_panic_matching,
        )
        for sim in self._handle.sims.values():
            sim.create_node(info.id)
        if self._ip is not None:
            from .net import NetSim

            self._handle.simulator(NetSim).set_ip(info.id, self._ip)
        if self._init is not None:
            ex.spawn_on(info, self._init(), name="init", spawn_site="init")
        return NodeHandle(self._handle, info)


class Runtime:
    """The simulation runtime (ref ``Runtime``, runtime/mod.rs:34-230).

    One ``Runtime`` = one seeded, single-threaded, deterministic execution.
    """

    def __init__(self, seed: Optional[int] = None,
                 config: Optional[Config] = None):
        if seed is None:
            import time as _walltime

            seed = _walltime.time_ns()  # ref builder.rs:64-73 default seed
        self.rng = GlobalRng(seed)
        self.time = make_time_handle(self.rng)
        self.config = config or Config()
        self.executor = Executor(self.rng, self.time)
        self.handle = Handle(self.rng, self.time, self.executor, self.config)
        # default device simulators (ref runtime/mod.rs:53-69)
        from .fs import FsSim
        from .net import NetSim

        self.handle.add_simulator(NetSim)
        self.handle.add_simulator(FsSim)

    @property
    def seed(self) -> int:
        return self.rng.seed

    def add_simulator(self, cls: Type[S]) -> S:
        return self.handle.add_simulator(cls)

    def create_node(self) -> NodeBuilder:
        return self.handle.create_node()

    def set_time_limit(self, seconds: float) -> None:
        self.executor.time_limit_ns = int(seconds * 1e9)

    def set_allow_system_thread(self, allow: bool) -> None:
        self._allow_system_thread = allow

    def block_on(self, main: Union[Coroutine[Any, Any, Any],
                                   Callable[[], Coroutine[Any, Any, Any]]]) -> Any:
        """Run the main future to completion inside the sim context
        (runtime/mod.rs:127-130)."""
        from .interpose import interposed

        coro = main() if callable(main) and not inspect.iscoroutine(main) else main
        assert inspect.iscoroutine(coro), "block_on expects a coroutine"
        allow_thread = getattr(self, "_allow_system_thread", False)
        _gc_relax()
        try:
            with context.enter_handle(self.handle), interposed(
                self.handle, allow_system_thread=allow_thread
            ):
                return self.executor.block_on(coro)
        finally:
            _gc_restore()

    @staticmethod
    def check_determinism(
        seed: int,
        f: Callable[[], Coroutine[Any, Any, Any]],
        config: Optional[Config] = None,
    ) -> Any:
        """Run ``f`` twice with the same seed, recording then replaying the
        RNG log; raises NondeterminismError at the first divergence
        (ref runtime/mod.rs:178-202, rand.rs:64-88)."""
        rt1 = Runtime(seed=seed, config=config)
        rt1.rng.enable_log()
        result = rt1.block_on(f())
        log = rt1.rng.take_log()
        assert log is not None
        rt2 = Runtime(seed=seed, config=config)
        rt2.rng.enable_check(log)
        rt2.block_on(f())
        return result


def init_logger(level: int = logging.INFO) -> None:
    """Install a logging config whose lines carry sim identity —
    ``[<sim_time>s <node>/<task>]`` — once (ref runtime/mod.rs:445-449;
    the span-per-node/task analogue lives in madsim_tpu_torch.tracing)."""
    from .tracing import LOG_FORMAT, SimContextFilter

    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=level, format=LOG_FORMAT)
        for handler in root.handlers:
            handler.addFilter(SimContextFilter())
