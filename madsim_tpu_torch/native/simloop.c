/* simloop — the compiled executor core of the host tier.
 *
 * The reference's entire simulation loop is compiled Rust
 * (madsim/src/sim/task/mod.rs:220-317 block_on/run_all_ready,
 * time/mod.rs:21-230 TimerHeap, async-task wakers).  This CPython
 * extension is that property for the Python host tier: the per-poll hot
 * sequence — random pop, flag checks, context swap, coroutine step,
 * pollable subscription, jitter advance, timer fire — runs in C, while
 * tasks, nodes and user coroutines stay ordinary Python objects.
 *
 * Determinism contract: pop indices and jitter use the SAME GlobalRng
 * draws in the same order as the pure-Python loop (the Lemire reduction
 * `u64 * n >> 64` on rng.next_u64()), the timer heap orders by
 * (deadline, insertion seq) exactly like the Python heapq path, and
 * Sleep arms its timer lazily on first subscribe, exactly like the
 * Python Sleep.  Schedules are byte-identical with the C core on or off
 * (MADSIM_NO_NATIVE=1 forces it off; tests/test_torch_native.py asserts
 * the transparency).
 *
 * Types:
 *   Future  — one-shot resolvable cell with FIFO waker list (the
 *             futures.Future contract; subclassable, JoinHandle extends
 *             it from Python).
 *   Sleep   — Future + lazily-armed virtual-time timer (time.Sleep).
 *   Timers  — binary heap of (deadline, seq, entry) + the monotonic
 *             virtual clock (time/mod.rs TimerHeap).
 *   TimerEntry — cancelable handle to one registration.
 *   Loop    — the executor driver bound to (executor, ready-list, rng,
 *             timers, thread-local context).
 *
 * Build: gcc -O2 -shared -fPIC -std=c11 -I<python-include> simloop.c
 *        -o _simloop.so (native/__init__.py builds it into _build/native/)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stddef.h>
#include <stdint.h>

/* interned attribute / method names (module-lifetime) */
static PyObject *s_wake, *s_subscribe, *s_scheduled, *s_finished, *s_cancelled,
    *s_node, *s_killed, *s_paused, *s_paused_tasks, *s_coro, *s_task,
    *s__drop_task, *s__complete, *s__poll_raised, *s_ns, *s__ready_items,
    *s_time_limit_ns, *s__raise_time_limit;

static PyObject *instant_cls = NULL; /* set by _configure() from time.py */

/* ------------------------------------------------------------------ Future */

typedef struct {
    PyObject_HEAD
    int state;          /* 0 pending, 1 result, 2 exception */
    PyObject *payload;  /* result value or exception instance */
    PyObject *wakers;   /* PyList of tasks, lazily created */
} FutureObj;

static PyTypeObject Future_Type;
static PyTypeObject Sleep_Type;

/* inlined Task.wake: flag checks + direct ready-list append.  Falls back
 * to the Python method when the task has no direct list (MADSIM_NATIVE's
 * ctypes queue). Task.wake never draws from the rng (the loop's cached
 * cursor relies on this). */
static int
task_wake(PyObject *task)
{
    PyObject *v = PyObject_GetAttr(task, s_finished);
    if (v == NULL)
        return -1;
    int skip = PyObject_IsTrue(v);
    Py_DECREF(v);
    if (skip < 0)
        return -1;
    if (skip)
        return 0;
    v = PyObject_GetAttr(task, s_scheduled);
    if (v == NULL)
        return -1;
    skip = PyObject_IsTrue(v);
    Py_DECREF(v);
    if (skip < 0)
        return -1;
    if (skip)
        return 0;
    PyObject *items = PyObject_GetAttr(task, s__ready_items);
    if (items == NULL) {
        PyErr_Clear(); /* not a task.py Task: generic wake() */
        PyObject *r = PyObject_CallMethodNoArgs(task, s_wake);
        if (r == NULL)
            return -1;
        Py_DECREF(r);
        return 0;
    }
    if (!PyList_Check(items)) {
        Py_DECREF(items);
        PyObject *r = PyObject_CallMethodNoArgs(task, s_wake);
        if (r == NULL)
            return -1;
        Py_DECREF(r);
        return 0;
    }
    if (PyObject_SetAttr(task, s_scheduled, Py_True) < 0) {
        Py_DECREF(items);
        return -1;
    }
    int rc = PyList_Append(items, task);
    Py_DECREF(items);
    return rc;
}

static int
future_wake_all(FutureObj *self)
{
    PyObject *wakers = self->wakers;
    if (wakers == NULL || PyList_GET_SIZE(wakers) == 0)
        return 0;
    self->wakers = NULL; /* detach: re-entrant subscribes build a new list */
    Py_ssize_t n = PyList_GET_SIZE(wakers);
    for (Py_ssize_t i = 0; i < n; i++) {
        if (task_wake(PyList_GET_ITEM(wakers, i)) < 0) {
            Py_DECREF(wakers);
            return -1;
        }
    }
    Py_DECREF(wakers);
    return 0;
}

/* C-level set_result(None)-equivalent used by the timer fire path */
static int
future_resolve_none(FutureObj *self)
{
    if (self->state != 0)
        return 0;
    self->state = 1;
    self->payload = Py_NewRef(Py_None);
    return future_wake_all(self);
}

static PyObject *
future_set_result(FutureObj *self, PyObject *value)
{
    if (self->state != 0)
        Py_RETURN_NONE;
    self->state = 1;
    self->payload = Py_NewRef(value);
    if (future_wake_all(self) < 0)
        return NULL;
    Py_RETURN_NONE;
}

static PyObject *
future_set_exception(FutureObj *self, PyObject *exc)
{
    if (!PyExceptionInstance_Check(exc)) {
        PyErr_SetString(PyExc_TypeError, "set_exception expects an exception instance");
        return NULL;
    }
    if (self->state != 0)
        Py_RETURN_NONE;
    self->state = 2;
    self->payload = Py_NewRef(exc);
    if (future_wake_all(self) < 0)
        return NULL;
    Py_RETURN_NONE;
}

static PyObject *
future_done(FutureObj *self, PyObject *Py_UNUSED(ignored))
{
    return PyBool_FromLong(self->state != 0);
}

static PyObject *
future_result(FutureObj *self, PyObject *Py_UNUSED(ignored))
{
    if (self->state == 1)
        return Py_NewRef(self->payload);
    if (self->state == 2) {
        PyErr_SetRaisedException(Py_NewRef(self->payload));
        return NULL;
    }
    PyErr_SetString(PyExc_RuntimeError, "future is not resolved yet");
    return NULL;
}

static PyObject *
future_exception(FutureObj *self, PyObject *Py_UNUSED(ignored))
{
    if (self->state == 2)
        return Py_NewRef(self->payload);
    Py_RETURN_NONE;
}

static PyObject *
future__reset(FutureObj *self, PyObject *Py_UNUSED(ignored))
{
    /* re-arm a resolved future (Sleep.reset); wakers are kept, matching
     * the Python Future._reset */
    self->state = 0;
    Py_CLEAR(self->payload);
    Py_RETURN_NONE;
}

/* shared by the method and the Loop fast path */
static int
future_subscribe_impl(FutureObj *self, PyObject *task)
{
    if (self->state != 0)
        return task_wake(task);
    if (self->wakers == NULL) {
        self->wakers = PyList_New(0);
        if (self->wakers == NULL)
            return -1;
    }
    int found = PySequence_Contains(self->wakers, task);
    if (found < 0)
        return -1;
    if (!found && PyList_Append(self->wakers, task) < 0)
        return -1;
    return 0;
}

static PyObject *
future_subscribe(FutureObj *self, PyObject *task)
{
    if (future_subscribe_impl(self, task) < 0)
        return NULL;
    Py_RETURN_NONE;
}

/* --- await protocol: the future IS its own iterator ----------------------
 * Stateless per-step (checks the future's state each __next__), so one
 * future shared by several awaiters is fine, and no per-await iterator
 * object is allocated. */

static PyObject *
future_iternext(FutureObj *self)
{
    if (self->state == 0)
        return Py_NewRef((PyObject *)self); /* yield the pollable */
    if (self->state == 1) {
        if (self->payload == Py_None)
            return NULL; /* bare StopIteration == StopIteration(None) */
        PyObject *exc = PyObject_CallFunctionObjArgs(
            PyExc_StopIteration, self->payload, NULL);
        if (exc != NULL)
            PyErr_SetRaisedException(exc);
        return NULL;
    }
    PyErr_SetRaisedException(Py_NewRef(self->payload));
    return NULL;
}

static PyObject *
future_await(FutureObj *self)
{
    return Py_NewRef((PyObject *)self);
}

static PyAsyncMethods future_as_async = {
    .am_await = (unaryfunc)future_await,
};

static int
future_init(FutureObj *self, PyObject *args, PyObject *kwds)
{
    /* accepts no arguments; subclass __init__s call super().__init__() */
    return 0;
}

static int
future_traverse(FutureObj *self, visitproc visit, void *arg)
{
    Py_VISIT(self->payload);
    Py_VISIT(self->wakers);
    return 0;
}

static int
future_clear(FutureObj *self)
{
    Py_CLEAR(self->payload);
    Py_CLEAR(self->wakers);
    return 0;
}

static void
future_dealloc(FutureObj *self)
{
    /* Python subclasses (JoinHandle) reach this through subtype_dealloc,
     * which handles slot teardown and the heap-type DECREF itself. */
    PyObject_GC_UnTrack(self);
    future_clear(self);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *
future_get_wakers(FutureObj *self, void *closure)
{
    /* live view for Python subclasses (time.Sleep checks `_wakers`) */
    if (self->wakers == NULL) {
        self->wakers = PyList_New(0);
        if (self->wakers == NULL)
            return NULL;
    }
    return Py_NewRef(self->wakers);
}

static PyGetSetDef future_getset[] = {
    {"_wakers", (getter)future_get_wakers, NULL, NULL, NULL},
    {NULL}
};

static PyMethodDef future_methods[] = {
    {"done", (PyCFunction)future_done, METH_NOARGS, NULL},
    {"result", (PyCFunction)future_result, METH_NOARGS, NULL},
    {"exception", (PyCFunction)future_exception, METH_NOARGS, NULL},
    {"set_result", (PyCFunction)future_set_result, METH_O, NULL},
    {"set_exception", (PyCFunction)future_set_exception, METH_O, NULL},
    {"_reset", (PyCFunction)future__reset, METH_NOARGS, NULL},
    {"subscribe", (PyCFunction)future_subscribe, METH_O, NULL},
    {NULL}
};

static PyTypeObject Future_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_simloop.Future",
    .tp_basicsize = sizeof(FutureObj),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE | Py_TPFLAGS_HAVE_GC,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)future_init,
    .tp_dealloc = (destructor)future_dealloc,
    .tp_traverse = (traverseproc)future_traverse,
    .tp_clear = (inquiry)future_clear,
    .tp_as_async = &future_as_async,
    .tp_iter = PyObject_SelfIter,
    .tp_iternext = (iternextfunc)future_iternext,
    .tp_methods = future_methods,
    .tp_getset = future_getset,
    .tp_doc = "One-shot resolvable value with deterministic FIFO waker list (C core).",
};

/* -------------------------------------------------------------- TimerEntry */

typedef struct {
    PyObject_HEAD
    int64_t deadline_ns;
    PyObject *target; /* Future to resolve with None, or 0-arg callable */
    char cancelled;
} TimerEntryObj;

static PyTypeObject TimerEntry_Type;

static PyObject *
timerentry_cancel(TimerEntryObj *self, PyObject *Py_UNUSED(ignored))
{
    self->cancelled = 1;
    Py_CLEAR(self->target); /* release the callback/future eagerly */
    Py_RETURN_NONE;
}

static int
timerentry_traverse(TimerEntryObj *self, visitproc visit, void *arg)
{
    Py_VISIT(self->target);
    return 0;
}

static int
timerentry_clear(TimerEntryObj *self)
{
    Py_CLEAR(self->target);
    return 0;
}

static void
timerentry_dealloc(TimerEntryObj *self)
{
    PyObject_GC_UnTrack(self);
    Py_CLEAR(self->target);
    PyObject_GC_Del(self);
}

static PyMemberDef timerentry_members[] = {
    {"deadline_ns", Py_T_LONGLONG, offsetof(TimerEntryObj, deadline_ns), Py_READONLY, NULL},
    {"cancelled", Py_T_BOOL, offsetof(TimerEntryObj, cancelled), Py_READONLY, NULL},
    {NULL}
};

static PyMethodDef timerentry_methods[] = {
    {"cancel", (PyCFunction)timerentry_cancel, METH_NOARGS, NULL},
    {NULL}
};

static PyTypeObject TimerEntry_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_simloop.TimerEntry",
    .tp_basicsize = sizeof(TimerEntryObj),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_dealloc = (destructor)timerentry_dealloc,
    .tp_traverse = (traverseproc)timerentry_traverse,
    .tp_clear = (inquiry)timerentry_clear,
    .tp_members = timerentry_members,
    .tp_methods = timerentry_methods,
    .tp_doc = "Cancelable handle to one timer registration.",
};

/* ------------------------------------------------------------------ Timers */

typedef struct {
    int64_t deadline;
    uint64_t seq;
    PyObject *target; /* strong: TimerEntryObj (kind 0) or SleepObj (kind 1) */
    uint64_t gen;     /* kind 1: must match the sleep's arm_gen to fire */
    char kind;
} HeapItem;

/* forward: kind-1 items check the sleep's generation */
static int heap_item_cancelled(const HeapItem *item);

typedef struct {
    PyObject_HEAD
    HeapItem *heap;
    Py_ssize_t size, cap;
    uint64_t next_seq;
    int64_t clock_ns;
    void *owner_loop; /* borrowed LoopObj*, see loop_init; may be NULL */
} TimersObj;

/* defined after LoopObj: flushes the loop's cached rng cursor before a
 * Python timer callback runs (callbacks may draw from the rng) */
static int loop_syncout_opaque(void *loop);

static PyTypeObject Timers_Type;

static inline int
heap_less(const HeapItem *a, const HeapItem *b)
{
    if (a->deadline != b->deadline)
        return a->deadline < b->deadline;
    return a->seq < b->seq;
}

static int
heap_reserve(TimersObj *t)
{
    if (t->size < t->cap)
        return 0;
    Py_ssize_t ncap = t->cap ? t->cap * 2 : 64;
    HeapItem *nh = (HeapItem *)PyMem_Realloc(t->heap, ncap * sizeof(HeapItem));
    if (nh == NULL) {
        PyErr_NoMemory();
        return -1;
    }
    t->heap = nh;
    t->cap = ncap;
    return 0;
}

static void
heap_sift_up(TimersObj *t, Py_ssize_t i)
{
    HeapItem item = t->heap[i];
    while (i > 0) {
        Py_ssize_t parent = (i - 1) >> 1;
        if (!heap_less(&item, &t->heap[parent]))
            break;
        t->heap[i] = t->heap[parent];
        i = parent;
    }
    t->heap[i] = item;
}

static void
heap_sift_down(TimersObj *t, Py_ssize_t i)
{
    HeapItem item = t->heap[i];
    Py_ssize_t n = t->size;
    for (;;) {
        Py_ssize_t child = 2 * i + 1;
        if (child >= n)
            break;
        if (child + 1 < n && heap_less(&t->heap[child + 1], &t->heap[child]))
            child += 1;
        if (!heap_less(&t->heap[child], &item))
            break;
        t->heap[i] = t->heap[child];
        i = child;
    }
    t->heap[i] = item;
}

/* pops the head; caller owns the reference in the returned item */
static HeapItem
heap_pop(TimersObj *t)
{
    HeapItem item = t->heap[0];
    t->size -= 1;
    if (t->size > 0) {
        t->heap[0] = t->heap[t->size];
        heap_sift_down(t, 0);
    }
    return item;
}

/* drop cancelled heads; returns 1 and sets *deadline if a live head exists */
static int
heap_live_head(TimersObj *t, int64_t *deadline)
{
    while (t->size > 0) {
        if (heap_item_cancelled(&t->heap[0])) {
            HeapItem item = heap_pop(t);
            Py_DECREF(item.target);
            continue;
        }
        *deadline = t->heap[0].deadline;
        return 1;
    }
    return 0;
}

static PyObject *
timers_push(TimersObj *self, PyObject *args)
{
    long long deadline;
    PyObject *target;
    if (!PyArg_ParseTuple(args, "LO", &deadline, &target))
        return NULL;
    TimerEntryObj *entry = PyObject_GC_New(TimerEntryObj, &TimerEntry_Type);
    if (entry == NULL)
        return NULL;
    entry->deadline_ns = deadline;
    entry->target = Py_NewRef(target);
    entry->cancelled = 0;
    PyObject_GC_Track((PyObject *)entry);
    if (heap_reserve(self) < 0) {
        Py_DECREF(entry);
        return NULL;
    }
    HeapItem *slot = &self->heap[self->size++];
    slot->deadline = deadline;
    slot->seq = ++self->next_seq; /* matches the Python pre-increment seq */
    slot->target = Py_NewRef((PyObject *)entry);
    slot->gen = 0;
    slot->kind = 0;
    heap_sift_up(self, self->size - 1);
    return (PyObject *)entry;
}

/* fire every entry due at the current clock; returns count or -1 */
static int
timers_fire_due_impl(TimersObj *self)
{
    int fired = 0;
    int64_t deadline;
    while (heap_live_head(self, &deadline) && deadline <= self->clock_ns) {
        HeapItem item = heap_pop(self);
        int rc;
        if (item.kind == 1) {
            /* direct sleep: resolving wakes tasks; Task.wake never draws
             * from the rng, so the loop's cached cursor stays valid */
            rc = future_resolve_none((FutureObj *)item.target);
            Py_DECREF(item.target);
        }
        else {
            TimerEntryObj *entry = (TimerEntryObj *)item.target;
            PyObject *target = entry->target;
            entry->target = NULL; /* transfer ownership */
            Py_DECREF(entry);
            if (target == NULL)
                continue; /* raced cancel */
            if (PyObject_TypeCheck(target, &Future_Type)) {
                rc = future_resolve_none((FutureObj *)target);
            }
            else {
                /* arbitrary Python callback: it may draw — flush the
                 * loop's cached rng cursor first */
                if (self->owner_loop != NULL &&
                    loop_syncout_opaque(self->owner_loop) < 0) {
                    Py_DECREF(target);
                    return -1;
                }
                PyObject *r = PyObject_CallNoArgs(target);
                rc = (r == NULL) ? -1 : 0;
                Py_XDECREF(r);
            }
            Py_DECREF(target);
        }
        if (rc < 0)
            return -1;
        fired += 1;
    }
    return fired;
}

static PyObject *
timers_fire_due(TimersObj *self, PyObject *Py_UNUSED(ignored))
{
    int n = timers_fire_due_impl(self);
    if (n < 0)
        return NULL;
    return PyLong_FromLong(n);
}

static PyObject *
timers_peek_deadline(TimersObj *self, PyObject *Py_UNUSED(ignored))
{
    int64_t deadline;
    if (!heap_live_head(self, &deadline))
        Py_RETURN_NONE;
    return PyLong_FromLongLong(deadline);
}

static PyObject *
timers_advance_ns(TimersObj *self, PyObject *arg)
{
    long long delta = PyLong_AsLongLong(arg);
    if (delta == -1 && PyErr_Occurred())
        return NULL;
    self->clock_ns += delta;
    if (self->size > 0 && self->heap[0].deadline <= self->clock_ns) {
        if (timers_fire_due_impl(self) < 0)
            return NULL;
    }
    Py_RETURN_NONE;
}

static PyObject *
timers_advance_to_next_event(TimersObj *self, PyObject *arg)
{
    long long epsilon = PyLong_AsLongLong(arg);
    if (epsilon == -1 && PyErr_Occurred())
        return NULL;
    int64_t deadline;
    if (!heap_live_head(self, &deadline))
        Py_RETURN_FALSE;
    int64_t jumped = deadline + epsilon;
    if (jumped > self->clock_ns)
        self->clock_ns = jumped;
    if (timers_fire_due_impl(self) < 0)
        return NULL;
    Py_RETURN_TRUE;
}

static Py_ssize_t
timers_len(TimersObj *self)
{
    return self->size;
}

static int
timers_traverse(TimersObj *self, visitproc visit, void *arg)
{
    for (Py_ssize_t i = 0; i < self->size; i++)
        Py_VISIT(self->heap[i].target);
    return 0;
}

static int
timers_clear_impl(TimersObj *self)
{
    Py_ssize_t n = self->size;
    self->size = 0;
    for (Py_ssize_t i = 0; i < n; i++)
        Py_CLEAR(self->heap[i].target);
    return 0;
}

static void
timers_dealloc(TimersObj *self)
{
    PyObject_GC_UnTrack(self);
    timers_clear_impl(self);
    PyMem_Free(self->heap);
    PyObject_GC_Del(self);
}

static PyObject *
timers_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    TimersObj *self = PyObject_GC_New(TimersObj, &Timers_Type);
    if (self == NULL)
        return NULL;
    self->heap = NULL;
    self->size = self->cap = 0;
    self->next_seq = 0;
    self->clock_ns = 0;
    self->owner_loop = NULL;
    PyObject_GC_Track((PyObject *)self);
    return (PyObject *)self;
}

static PyMemberDef timers_members[] = {
    {"clock", Py_T_LONGLONG, offsetof(TimersObj, clock_ns), 0, NULL},
    {NULL}
};

static PySequenceMethods timers_as_sequence = {
    .sq_length = (lenfunc)timers_len,
};

static PyMethodDef timers_methods[] = {
    {"push", (PyCFunction)timers_push, METH_VARARGS, NULL},
    {"fire_due", (PyCFunction)timers_fire_due, METH_NOARGS, NULL},
    {"peek_deadline", (PyCFunction)timers_peek_deadline, METH_NOARGS, NULL},
    {"advance_ns", (PyCFunction)timers_advance_ns, METH_O, NULL},
    {"advance_to_next_event", (PyCFunction)timers_advance_to_next_event, METH_O, NULL},
    {NULL}
};

static PyTypeObject Timers_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_simloop.Timers",
    .tp_basicsize = sizeof(TimersObj),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_new = timers_new,
    .tp_dealloc = (destructor)timers_dealloc,
    .tp_traverse = (traverseproc)timers_traverse,
    .tp_clear = (inquiry)timers_clear_impl,
    .tp_members = timers_members,
    .tp_methods = timers_methods,
    .tp_as_sequence = &timers_as_sequence,
    .tp_doc = "Virtual clock + (deadline, seq)-ordered timer heap (C core).",
};

/* ------------------------------------------------------------------- Sleep */

typedef struct {
    FutureObj base;
    TimersObj *timers; /* strong */
    int64_t deadline_ns;
    uint64_t arm_gen;  /* bumped on reset; a queued heap item with a stale
                        * gen is dead (no TimerEntry object, no ref cycle) */
    char armed;
} SleepObj;

static int
heap_item_cancelled(const HeapItem *item)
{
    if (item->kind == 1)
        return ((SleepObj *)item->target)->arm_gen != item->gen;
    return ((TimerEntryObj *)item->target)->cancelled;
}

static int
sleep_arm(SleepObj *self)
{
    /* lazily register the timer — first-poll registration, matching the
     * Python Sleep (sleep.rs:30-44 waker semantics) */
    if (self->base.state != 0 || self->armed)
        return 0;
    if (self->deadline_ns <= self->timers->clock_ns)
        return future_resolve_none(&self->base);
    TimersObj *t = self->timers;
    if (heap_reserve(t) < 0)
        return -1;
    HeapItem *slot = &t->heap[t->size++];
    slot->deadline = self->deadline_ns;
    slot->seq = ++t->next_seq;
    slot->target = Py_NewRef((PyObject *)self);
    slot->gen = self->arm_gen;
    slot->kind = 1;
    heap_sift_up(t, t->size - 1);
    self->armed = 1;
    return 0;
}

static int
sleep_subscribe_impl(SleepObj *self, PyObject *task)
{
    if (sleep_arm(self) < 0)
        return -1;
    return future_subscribe_impl(&self->base, task);
}

static PyObject *
sleep_subscribe(SleepObj *self, PyObject *task)
{
    if (sleep_subscribe_impl(self, task) < 0)
        return NULL;
    Py_RETURN_NONE;
}

static PyObject *
sleep_reset(SleepObj *self, PyObject *deadline_obj)
{
    /* Sleep::reset (sleep.rs:47-55): move the deadline; if tasks are
     * already awaiting, re-arm immediately (they won't re-subscribe). */
    long long ns;
    if (PyLong_Check(deadline_obj)) {
        ns = PyLong_AsLongLong(deadline_obj);
    }
    else {
        PyObject *nso = PyObject_GetAttr(deadline_obj, s_ns); /* Instant */
        if (nso == NULL)
            return NULL;
        ns = PyLong_AsLongLong(nso);
        Py_DECREF(nso);
    }
    if (ns == -1 && PyErr_Occurred())
        return NULL;
    /* invalidate any queued registration (stale gen is skipped lazily) */
    self->arm_gen += 1;
    self->armed = 0;
    self->base.state = 0;
    Py_CLEAR(self->base.payload);
    self->deadline_ns = ns;
    if (self->base.wakers != NULL && PyList_GET_SIZE(self->base.wakers) > 0) {
        if (sleep_arm(self) < 0)
            return NULL;
    }
    Py_RETURN_NONE;
}

static PyObject *
sleep_is_elapsed(SleepObj *self, PyObject *Py_UNUSED(ignored))
{
    return PyBool_FromLong(self->base.state != 0);
}

static PyObject *
sleep_get_deadline(SleepObj *self, void *closure)
{
    if (instant_cls == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "_simloop._configure was not called");
        return NULL;
    }
    PyObject *ns = PyLong_FromLongLong(self->deadline_ns);
    if (ns == NULL)
        return NULL;
    PyObject *r = PyObject_CallOneArg(instant_cls, ns);
    Py_DECREF(ns);
    return r;
}

static int
sleep_init(SleepObj *self, PyObject *args, PyObject *kwds)
{
    PyObject *timers;
    long long deadline;
    if (!PyArg_ParseTuple(args, "OL", &timers, &deadline))
        return -1;
    if (!PyObject_TypeCheck(timers, &Timers_Type)) {
        PyErr_SetString(PyExc_TypeError, "Sleep expects a _simloop.Timers core");
        return -1;
    }
    Py_XSETREF(self->timers, (TimersObj *)Py_NewRef(timers));
    self->deadline_ns = deadline;
    return 0;
}

static int
sleep_traverse(SleepObj *self, visitproc visit, void *arg)
{
    Py_VISIT((PyObject *)self->timers);
    return future_traverse(&self->base, visit, arg);
}

static int
sleep_clear(SleepObj *self)
{
    Py_CLEAR(self->timers);
    return future_clear(&self->base);
}

static void
sleep_dealloc(SleepObj *self)
{
    /* while armed the heap holds a strong ref, so dealloc implies the
     * sleep is not queued — nothing to cancel */
    PyObject_GC_UnTrack(self);
    sleep_clear(self);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef sleep_methods[] = {
    {"subscribe", (PyCFunction)sleep_subscribe, METH_O, NULL},
    {"reset", (PyCFunction)sleep_reset, METH_O, NULL},
    {"is_elapsed", (PyCFunction)sleep_is_elapsed, METH_NOARGS, NULL},
    {NULL}
};

static PyGetSetDef sleep_getset[] = {
    {"deadline", (getter)sleep_get_deadline, NULL, NULL, NULL},
    {NULL}
};

static PyTypeObject Sleep_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_simloop.Sleep",
    .tp_basicsize = sizeof(SleepObj),
    .tp_base = &Future_Type,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE | Py_TPFLAGS_HAVE_GC,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)sleep_init,
    .tp_dealloc = (destructor)sleep_dealloc,
    .tp_traverse = (traverseproc)sleep_traverse,
    .tp_clear = (inquiry)sleep_clear,
    .tp_methods = sleep_methods,
    .tp_getset = sleep_getset,
    .tp_doc = "Future resolving when the virtual clock reaches the deadline (C core).",
};

/* -------------------------------------------------------------------- Loop */

typedef struct {
    PyObject_HEAD
    PyObject *executor;    /* madsim_tpu_torch.task.Executor */
    PyObject *ready_items; /* the _PyReadyQueue._items list */
    PyObject *rng;         /* the GlobalRng */
    PyObject *rng_next;    /* bound GlobalRng.next_u64 (slow path) */
    TimersObj *timers;
    PyObject *tls;         /* madsim_tpu_torch.context._tls */
    /* direct view of the rng's refill buffer.  Valid only between sync_in
     * and the next call into arbitrary Python (which may draw itself);
     * sync_out writes _buf_pos/_draw_count back before any such call. */
    PyObject *buf;         /* borrowed from rng._buf while valid */
    Py_ssize_t buf_pos;
    Py_ssize_t buf_len;
    long long draws;
    int rng_valid;         /* cached view is current */
    int rng_fast;          /* log/check off -> direct buffer reads allowed */
} LoopObj;

static PyTypeObject Loop_Type;

static PyObject *s__buf, *s__buf_pos, *s__draw_count, *s__log, *s__check;

/* write the cached cursor back onto the Python rng */
static int
loop_rng_sync_out(LoopObj *self)
{
    if (!self->rng_valid)
        return 0;
    self->rng_valid = 0;
    PyObject *pos = PyLong_FromSsize_t(self->buf_pos);
    if (pos == NULL)
        return -1;
    int rc = PyObject_SetAttr(self->rng, s__buf_pos, pos);
    Py_DECREF(pos);
    if (rc < 0)
        return -1;
    PyObject *draws = PyLong_FromLongLong(self->draws);
    if (draws == NULL)
        return -1;
    rc = PyObject_SetAttr(self->rng, s__draw_count, draws);
    Py_DECREF(draws);
    return rc;
}

static int
loop_rng_sync_in(LoopObj *self)
{
    PyObject *buf = PyObject_GetAttr(self->rng, s__buf);
    if (buf == NULL)
        return -1;
    if (!PyList_CheckExact(buf)) { /* None (not yet filled) or foreign type */
        Py_DECREF(buf);
        self->rng_valid = 0;
        self->buf = NULL;
        self->buf_pos = self->buf_len = 0;
        return 1; /* fall back to the Python call for this draw */
    }
    PyObject *pos = PyObject_GetAttr(self->rng, s__buf_pos);
    if (pos == NULL) {
        Py_DECREF(buf);
        return -1;
    }
    PyObject *draws = PyObject_GetAttr(self->rng, s__draw_count);
    if (draws == NULL) {
        Py_DECREF(buf);
        Py_DECREF(pos);
        return -1;
    }
    self->buf_pos = PyLong_AsSsize_t(pos);
    self->draws = PyLong_AsLongLong(draws);
    Py_DECREF(pos);
    Py_DECREF(draws);
    if (PyErr_Occurred()) {
        Py_DECREF(buf);
        return -1;
    }
    self->buf_len = PyList_GET_SIZE(buf);
    self->buf = buf; /* borrowed: rng._buf keeps it alive while valid */
    Py_DECREF(buf);
    self->rng_valid = 1;
    return 0;
}

static int
loop_rng_draw(LoopObj *self, uint64_t *out)
{
    if (self->rng_fast) {
        if (!self->rng_valid) {
            int rc = loop_rng_sync_in(self);
            if (rc < 0)
                return -1;
        }
        if (self->rng_valid && self->buf_pos < self->buf_len) {
            uint64_t v = PyLong_AsUnsignedLongLong(
                PyList_GET_ITEM(self->buf, self->buf_pos));
            if (v == (uint64_t)-1 && PyErr_Occurred())
                return -1;
            self->buf_pos += 1;
            self->draws += 1;
            *out = v;
            return 0;
        }
        /* exhausted or unfilled: let the Python refill path handle it */
        if (loop_rng_sync_out(self) < 0)
            return -1;
    }
    PyObject *vo = PyObject_CallNoArgs(self->rng_next);
    if (vo == NULL)
        return -1;
    uint64_t v = PyLong_AsUnsignedLongLong(vo);
    Py_DECREF(vo);
    if (v == (uint64_t)-1 && PyErr_Occurred())
        return -1;
    *out = v;
    return 0;
}

/* refresh the log/check gate.  Called once per drain iteration and again
 * before the per-poll advance draw, so enable_log()/enable_check() invoked
 * from INSIDE a task mid-drain takes effect from the very next draw (the
 * pure-Python next_u64 checks per draw; this keeps the native schedule's
 * determinism log byte-identical in that edge case).  Flipping fast->slow
 * hands the cached cursor back first so rng_next resumes at the right
 * buffer position. */
static int
loop_rng_gate(LoopObj *self)
{
    PyObject *log = PyObject_GetAttr(self->rng, s__log);
    if (log == NULL)
        return -1;
    PyObject *check = PyObject_GetAttr(self->rng, s__check);
    if (check == NULL) {
        Py_DECREF(log);
        return -1;
    }
    int fast = (log == Py_None && check == Py_None);
    Py_DECREF(log);
    Py_DECREF(check);
    if (!fast && self->rng_fast && loop_rng_sync_out(self) < 0)
        return -1;
    self->rng_fast = fast;
    return 0;
}

static inline int
attr_is_true(PyObject *obj, PyObject *name, int *out)
{
    PyObject *v = PyObject_GetAttr(obj, name);
    if (v == NULL)
        return -1;
    int t = PyObject_IsTrue(v);
    Py_DECREF(v);
    if (t < 0)
        return -1;
    *out = t;
    return 0;
}

static int
loop_syncout_opaque(void *loop)
{
    return loop_rng_sync_out((LoopObj *)loop);
}

static PyObject *
loop_run_all_ready(LoopObj *self, PyObject *Py_UNUSED(ignored))
{
    PyObject *items = self->ready_items;
    TimersObj *timers = self->timers;
    PyObject *tls = self->tls;

    for (;;) {
        /* re-gate each iteration: the previous iteration may have run task
         * code (poll, drop finally-blocks) that toggled log/check */
        if (loop_rng_gate(self) < 0)
            return NULL;
        Py_ssize_t n = PyList_GET_SIZE(items);
        if (n == 0)
            break;

        /* random swap-remove pop: same Lemire draw as the Python path */
        uint64_t v;
        if (loop_rng_draw(self, &v) < 0)
            return NULL;
        Py_ssize_t idx = (Py_ssize_t)(((unsigned __int128)v * (uint64_t)n) >> 64);

        PyObject *task = Py_NewRef(PyList_GET_ITEM(items, idx));
        PyList_SetItem(items, idx, Py_NewRef(PyList_GET_ITEM(items, n - 1)));
        if (PyList_SetSlice(items, n - 1, n, NULL) < 0) {
            Py_DECREF(task);
            return NULL;
        }

        if (PyObject_SetAttr(task, s_scheduled, Py_False) < 0) {
            Py_DECREF(task);
            return NULL;
        }
        int flag;
        if (attr_is_true(task, s_finished, &flag) < 0) {
            Py_DECREF(task);
            return NULL;
        }
        if (flag) {
            Py_DECREF(task);
            continue;
        }
        PyObject *node = PyObject_GetAttr(task, s_node);
        if (node == NULL) {
            Py_DECREF(task);
            return NULL;
        }
        int cancelled, killed;
        if (attr_is_true(task, s_cancelled, &cancelled) < 0 ||
            attr_is_true(node, s_killed, &killed) < 0) {
            Py_DECREF(node);
            Py_DECREF(task);
            return NULL;
        }
        if (cancelled || killed) {
            /* coro.close() runs finally blocks, which may draw */
            if (loop_rng_sync_out(self) < 0) {
                Py_DECREF(node);
                Py_DECREF(task);
                return NULL;
            }
            PyObject *r = PyObject_CallMethodObjArgs(
                self->executor, s__drop_task, task, NULL);
            Py_DECREF(node);
            Py_DECREF(task);
            if (r == NULL)
                return NULL;
            Py_DECREF(r);
            continue;
        }
        int paused;
        if (attr_is_true(node, s_paused, &paused) < 0) {
            Py_DECREF(node);
            Py_DECREF(task);
            return NULL;
        }
        if (paused) {
            /* park until resume (ref task/mod.rs:271-276) */
            PyObject *pt = PyObject_GetAttr(node, s_paused_tasks);
            Py_DECREF(node);
            if (pt == NULL) {
                Py_DECREF(task);
                return NULL;
            }
            int rc;
            if (PyList_Check(pt)) {
                rc = PyList_Append(pt, task);
            }
            else {
                rc = loop_rng_sync_out(self);
                if (rc == 0) {
                    PyObject *r = PyObject_CallMethod(pt, "append", "O", task);
                    rc = (r == NULL) ? -1 : 0;
                    Py_XDECREF(r);
                }
            }
            Py_DECREF(pt);
            Py_DECREF(task);
            if (rc < 0)
                return NULL;
            continue;
        }
        Py_DECREF(node);

        /* ---- poll: step the coroutine inside the task context ---- */
        PyObject *coro = PyObject_GetAttr(task, s_coro);
        if (coro == NULL) {
            Py_DECREF(task);
            return NULL;
        }
        PyObject *prev = PyObject_GetAttr(tls, s_task);
        if (prev == NULL) {
            PyErr_Clear();
            prev = Py_NewRef(Py_None);
        }
        if (PyObject_SetAttr(tls, s_task, task) < 0) {
            Py_DECREF(prev);
            Py_DECREF(coro);
            Py_DECREF(task);
            return NULL;
        }
        /* the coroutine body may draw from the rng */
        if (loop_rng_sync_out(self) < 0) {
            Py_DECREF(prev);
            Py_DECREF(coro);
            Py_DECREF(task);
            return NULL;
        }
        PyObject *pollable = NULL;
        PySendResult sr = PyIter_Send(coro, Py_None, &pollable);
        Py_DECREF(coro);
        /* restore context before completion/panic handling, matching the
         * Python finally */
        if (PyObject_SetAttr(tls, s_task, prev) < 0) {
            Py_DECREF(prev);
            Py_XDECREF(pollable);
            Py_DECREF(task);
            return NULL;
        }
        Py_DECREF(prev);

        if (sr == PYGEN_RETURN) {
            /* cursor is already flushed (sync_out precedes every send) and
             * the coroutine may have drawn, so the cache is stale — it
             * re-syncs on the next draw */
            PyObject *r = PyObject_CallMethodObjArgs(
                self->executor, s__complete, task, pollable, NULL);
            Py_DECREF(pollable);
            Py_DECREF(task);
            if (r == NULL)
                return NULL;
            Py_DECREF(r);
        }
        else if (sr == PYGEN_ERROR) {
            PyObject *exc = PyErr_GetRaisedException();
            PyObject *handled = PyObject_CallMethodObjArgs(
                self->executor, s__poll_raised, task, exc, NULL);
            if (handled == NULL) {
                Py_DECREF(exc);
                Py_DECREF(task);
                return NULL;
            }
            int h = PyObject_IsTrue(handled);
            Py_DECREF(handled);
            if (h <= 0) {
                /* not handled (KeyboardInterrupt etc.): propagate */
                PyErr_SetRaisedException(exc);
                Py_DECREF(task);
                return NULL;
            }
            Py_DECREF(exc);
            Py_DECREF(task);
        }
        else {
            /* subscribe the yielded pollable; C fast path for the exact
             * core types, generic dispatch otherwise */
            int rc;
            PyTypeObject *pt = Py_TYPE(pollable);
            if (pt == &Sleep_Type)
                rc = sleep_subscribe_impl((SleepObj *)pollable, task);
            else if (pt == &Future_Type)
                rc = future_subscribe_impl((FutureObj *)pollable, task);
            else {
                /* arbitrary subscribe may draw (netsim pollables) */
                rc = loop_rng_sync_out(self);
                if (rc == 0) {
                    PyObject *r = PyObject_CallMethodObjArgs(
                        pollable, s_subscribe, task, NULL);
                    rc = (r == NULL) ? -1 : 0;
                    Py_XDECREF(r);
                }
            }
            Py_DECREF(pollable);
            Py_DECREF(task);
            if (rc < 0)
                return NULL;
        }

        /* random 50-100 ns advance per poll (ref task/mod.rs:312-315);
         * the poll above ran task code, so re-gate before drawing */
        if (loop_rng_gate(self) < 0)
            return NULL;
        if (loop_rng_draw(self, &v) < 0)
            return NULL;
        timers->clock_ns += 50 + (int64_t)(((unsigned __int128)v * 51) >> 64);
        if (timers->size > 0 && timers->heap[0].deadline <= timers->clock_ns) {
            if (timers_fire_due_impl(timers) < 0)
                return NULL;
        }
    }
    /* hand the cursor back before returning to Python */
    if (loop_rng_sync_out(self) < 0)
        return NULL;
    Py_RETURN_NONE;
}

static PyObject *
loop_run(LoopObj *self, PyObject *args)
{
    /* the block_on inner loop (ref task/mod.rs:220-260): drain ready,
     * check main, jump to the next timer.  The time limit is RE-READ from
     * the executor each iteration (not snapshotted) so a mid-sim
     * set_time_limit behaves identically to the Python loop. */
    PyObject *main_join;        /* a Future (JoinHandle) */
    PyObject *deadlock_exc;     /* exception CLASS for deadlock */
    long long epsilon = 50;
    if (!PyArg_ParseTuple(args, "OO|L", &main_join, &deadlock_exc, &epsilon))
        return NULL;
    if (!PyObject_TypeCheck(main_join, &Future_Type)) {
        PyErr_SetString(PyExc_TypeError, "main_join must be a Future");
        return NULL;
    }
    FutureObj *main_fut = (FutureObj *)main_join;
    TimersObj *timers = self->timers;
    for (;;) {
        PyObject *r = loop_run_all_ready(self, NULL);
        if (r == NULL)
            return NULL;
        Py_DECREF(r);
        if (main_fut->state == 1)
            return Py_NewRef(main_fut->payload);
        if (main_fut->state == 2) {
            PyErr_SetRaisedException(Py_NewRef(main_fut->payload));
            return NULL;
        }
        int64_t deadline;
        if (!heap_live_head(timers, &deadline)) {
            PyErr_SetString(deadlock_exc,
                "deadlock detected: no timers are pending and every task "
                "is blocked — the simulation can never make progress");
            return NULL;
        }
        int64_t jumped = deadline + epsilon;
        if (jumped > timers->clock_ns)
            timers->clock_ns = jumped;
        if (timers_fire_due_impl(timers) < 0)
            return NULL;
        PyObject *limit = PyObject_GetAttr(self->executor, s_time_limit_ns);
        if (limit == NULL)
            return NULL;
        if (limit != Py_None) {
            long long lim = PyLong_AsLongLong(limit);
            Py_DECREF(limit);
            if (lim == -1 && PyErr_Occurred())
                return NULL;
            if (timers->clock_ns > lim) {
                /* the helper raises TimeLimitError with the formatted
                 * message the Python loop produces */
                PyObject *r = PyObject_CallMethodNoArgs(
                    self->executor, s__raise_time_limit);
                if (r != NULL) { /* helper must raise */
                    Py_DECREF(r);
                    PyErr_SetString(PyExc_RuntimeError,
                                    "_raise_time_limit did not raise");
                }
                return NULL;
            }
        }
        else {
            Py_DECREF(limit);
        }
    }
}

static int
loop_init(LoopObj *self, PyObject *args, PyObject *kwds)
{
    PyObject *executor, *ready_items, *rng, *timers, *tls;
    if (!PyArg_ParseTuple(args, "OOOOO", &executor, &ready_items, &rng,
                          &timers, &tls))
        return -1;
    if (!PyList_Check(ready_items)) {
        PyErr_SetString(PyExc_TypeError, "ready_items must be a list");
        return -1;
    }
    if (!PyObject_TypeCheck(timers, &Timers_Type)) {
        PyErr_SetString(PyExc_TypeError, "timers must be a _simloop.Timers");
        return -1;
    }
    PyObject *rng_next = PyObject_GetAttrString(rng, "next_u64");
    if (rng_next == NULL)
        return -1;
    Py_XSETREF(self->executor, Py_NewRef(executor));
    Py_XSETREF(self->ready_items, Py_NewRef(ready_items));
    Py_XSETREF(self->rng, Py_NewRef(rng));
    Py_XSETREF(self->rng_next, rng_next);
    Py_XSETREF(self->timers, (TimersObj *)Py_NewRef(timers));
    Py_XSETREF(self->tls, Py_NewRef(tls));
    self->buf = NULL;
    self->buf_pos = self->buf_len = 0;
    self->draws = 0;
    self->rng_valid = 0;
    self->rng_fast = 0;
    /* let timer callbacks flush our cached rng cursor */
    self->timers->owner_loop = (void *)self;
    return 0;
}

static int
loop_traverse(LoopObj *self, visitproc visit, void *arg)
{
    Py_VISIT(self->executor);
    Py_VISIT(self->ready_items);
    Py_VISIT(self->rng);
    Py_VISIT(self->rng_next);
    Py_VISIT((PyObject *)self->timers);
    Py_VISIT(self->tls);
    return 0;
}

static int
loop_clear(LoopObj *self)
{
    if (self->timers != NULL && self->timers->owner_loop == (void *)self)
        self->timers->owner_loop = NULL;
    Py_CLEAR(self->executor);
    Py_CLEAR(self->ready_items);
    Py_CLEAR(self->rng);
    Py_CLEAR(self->rng_next);
    Py_CLEAR(self->timers);
    Py_CLEAR(self->tls);
    self->buf = NULL;
    self->rng_valid = 0;
    return 0;
}

static void
loop_dealloc(LoopObj *self)
{
    PyObject_GC_UnTrack(self);
    loop_clear(self);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef loop_methods[] = {
    {"run_all_ready", (PyCFunction)loop_run_all_ready, METH_NOARGS, NULL},
    {"run", (PyCFunction)loop_run, METH_VARARGS, NULL},
    {NULL}
};

static PyTypeObject Loop_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_simloop.Loop",
    .tp_basicsize = sizeof(LoopObj),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)loop_init,
    .tp_dealloc = (destructor)loop_dealloc,
    .tp_traverse = (traverseproc)loop_traverse,
    .tp_clear = (inquiry)loop_clear,
    .tp_methods = loop_methods,
    .tp_doc = "The executor's compiled ready-loop driver.",
};

/* ------------------------------------------------------------------ module */

static PyObject *
mod_configure(PyObject *module, PyObject *arg)
{
    /* time.py hands us its Instant class for Sleep.deadline */
    Py_XSETREF(instant_cls, Py_NewRef(arg));
    Py_RETURN_NONE;
}

static PyMethodDef module_methods[] = {
    {"_configure", (PyCFunction)mod_configure, METH_O, NULL},
    {NULL}
};

static struct PyModuleDef simloop_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "_simloop",
    .m_doc = "Compiled executor core (ready loop, timers, futures) for the host tier.",
    .m_size = -1,
    .m_methods = module_methods,
};

PyMODINIT_FUNC
PyInit__simloop(void)
{
    s_wake = PyUnicode_InternFromString("wake");
    s_subscribe = PyUnicode_InternFromString("subscribe");
    s_scheduled = PyUnicode_InternFromString("scheduled");
    s_finished = PyUnicode_InternFromString("finished");
    s_cancelled = PyUnicode_InternFromString("cancelled");
    s_node = PyUnicode_InternFromString("node");
    s_killed = PyUnicode_InternFromString("killed");
    s_paused = PyUnicode_InternFromString("paused");
    s_paused_tasks = PyUnicode_InternFromString("paused_tasks");
    s_coro = PyUnicode_InternFromString("coro");
    s_task = PyUnicode_InternFromString("task");
    s__drop_task = PyUnicode_InternFromString("_drop_task");
    s__complete = PyUnicode_InternFromString("_complete");
    s__poll_raised = PyUnicode_InternFromString("_poll_raised");
    s_ns = PyUnicode_InternFromString("ns");
    s__buf = PyUnicode_InternFromString("_buf");
    s__buf_pos = PyUnicode_InternFromString("_buf_pos");
    s__draw_count = PyUnicode_InternFromString("_draw_count");
    s__log = PyUnicode_InternFromString("_log");
    s__check = PyUnicode_InternFromString("_check");
    s__ready_items = PyUnicode_InternFromString("_ready_items");
    s_time_limit_ns = PyUnicode_InternFromString("time_limit_ns");
    s__raise_time_limit = PyUnicode_InternFromString("_raise_time_limit");

    if (PyType_Ready(&Future_Type) < 0 ||
        PyType_Ready(&TimerEntry_Type) < 0 || PyType_Ready(&Timers_Type) < 0 ||
        PyType_Ready(&Sleep_Type) < 0 || PyType_Ready(&Loop_Type) < 0)
        return NULL;

    PyObject *m = PyModule_Create(&simloop_module);
    if (m == NULL)
        return NULL;
    if (PyModule_AddObjectRef(m, "Future", (PyObject *)&Future_Type) < 0 ||
        PyModule_AddObjectRef(m, "Sleep", (PyObject *)&Sleep_Type) < 0 ||
        PyModule_AddObjectRef(m, "TimerEntry", (PyObject *)&TimerEntry_Type) < 0 ||
        PyModule_AddObjectRef(m, "Timers", (PyObject *)&Timers_Type) < 0 ||
        PyModule_AddObjectRef(m, "Loop", (PyObject *)&Loop_Type) < 0) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
