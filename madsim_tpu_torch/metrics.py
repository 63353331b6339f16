"""Runtime metrics (ref madsim/src/sim/runtime/metrics.rs:6-40;
impl task/mod.rs:490-534)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict

if TYPE_CHECKING:
    from .task import Executor


class RuntimeMetrics:
    def __init__(self, executor: "Executor"):
        self._executor = executor

    def num_nodes(self) -> int:
        return len(self._executor.nodes)

    def num_tasks(self) -> int:
        return self._executor.num_tasks()

    def num_tasks_by_node(self) -> Dict[str, int]:
        return self._executor.num_tasks_by_node()

    def num_tasks_by_spawn_site(self) -> Dict[str, int]:
        return self._executor.num_tasks_by_spawn_site()
