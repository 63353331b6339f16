"""Operation-history code constants (copied from
``madsim_tpu/oracle/history.py``). A history row's ``code`` column is
``op * 2 + phase``; raft records one ``OP_ELECT`` invoke row per won
election. The decoder and checkers are not ported yet."""

# op kinds
OP_PUT = 0
OP_GET = 1
OP_DEL = 2
OP_PRODUCE = 3
OP_FETCH = 4
OP_ELECT = 5

# phases
PH_INVOKE = 0
PH_OK = 1


def code_of(op: int, phase: int) -> int:
    """The row code the record hooks write: ``op * 2 + phase``."""
    return op * 2 + phase
