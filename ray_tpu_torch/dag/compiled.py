"""DAG execution: the dynamic walk and the compiled static schedule
(counterpart of ``ray_tpu/dag/compiled.py``).

A compile-time topological schedule, executed per call without a graph
traversal. Between in-process actors values flow through in-process slots,
between process-worker actors through one shared-memory channel an edge
(``shm_channel.py``); any other DAG runs the dynamic path, one task submit
a node.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ray_tpu_torch.dag.node import (ClassMethodNode, DAGNode,
                                    FunctionNode, InputNode,
                                    MultiOutputNode)


def _submit_node(node: DAGNode, resolved: Dict[int, Any]):
    """Submit one node's task with upstream results substituted."""
    def sub(a):
        return resolved[a.id] if isinstance(a, DAGNode) else a

    args = tuple(sub(a) for a in node.args)
    kwargs = {k: sub(v) for k, v in node.kwargs.items()}
    if isinstance(node, FunctionNode):
        return node.remote_function.remote(*args, **kwargs)
    if isinstance(node, ClassMethodNode):
        method = getattr(node.actor_handle, node.method_name)
        return method.remote(*args, **kwargs)
    raise TypeError(f"cannot submit {node!r}")


def _execute_dag(root: DAGNode, input_args: Tuple, input_kwargs: Dict):
    order = root.topo_sort()
    return _run_schedule(order, root, input_args)


def _run_schedule(order: List[DAGNode], root: DAGNode,
                  input_args: Tuple):
    resolved: Dict[int, Any] = {}
    for node in order:
        if isinstance(node, InputNode):
            if not input_args:
                raise ValueError("DAG has an InputNode but execute() got "
                                 "no argument")
            resolved[node.id] = input_args[0]
        elif isinstance(node, MultiOutputNode):
            resolved[node.id] = [resolved[o.id] for o in node.args]
        else:
            resolved[node.id] = _submit_node(node, resolved)
    return resolved[root.id]


class _Slot:
    """One edge's value channel for one execution (the shm-mutable-object
    role of ``experimental_mutable_object_manager.h:44`` collapsed to an
    in-process slot: the compiled data plane never touches the object
    store)."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        import threading

        self._event = threading.Event()
        self._value = None
        self._error = None

    def put(self, value) -> None:
        self._value = value
        self._event.set()

    def put_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def get(self, timeout: float = 300.0):
        if not self._event.wait(timeout):
            raise TimeoutError("compiled DAG channel read timed out")
        if self._error is not None:
            raise self._error
        return self._value


class CompiledDAG:
    """Pre-computed schedule with pre-bound channels.

    Reference: ``CompiledDAG`` (`compiled_dag_node.py:809`) — at compile
    time the schedule and channels are fixed; per execute() nothing goes
    through the scheduler. Here, when every compute node is a method on
    an in-process sync actor, each node becomes a *direct op* queued on
    its actor's executor thread: values flow actor→actor through
    ``_Slot`` channels (plain objects, no object store), each actor's
    executor pipelines its stage, and only the FINAL result is sealed
    into an ObjectRef for the caller. DAGs with task nodes, async
    actors, or daemon-remote actors fall back to the dynamic schedule.
    """

    def __init__(self, root: DAGNode, *,
                 buffer_size_bytes: int = 1 << 20):
        self.root = root
        self.schedule = root.topo_sort()
        # static validation at compile time (reference does channel
        # allocation + schedule checks here)
        n_inputs = sum(isinstance(n, InputNode) for n in self.schedule)
        if n_inputs > 1:
            raise ValueError("compiled DAGs support a single InputNode")
        self._teardown = False
        self._buffer_size = buffer_size_bytes
        self._proc = None
        # One submit at a time: a round's input-channel writes and its
        # rounds.put must be atomic or concurrent execute() calls can
        # interleave writes across channels and mispair round outputs
        # with ObjectRefs.
        self._submit_lock = __import__("threading").Lock()
        self._executors = self._bind_executors()
        if self._executors is None:
            # cross-process mode: pre-allocated shm channels + a
            # persistent per-actor loop — zero RPCs per execute()
            self._proc = self._bind_process_channels()

    @staticmethod
    def _resolve_live_executor(rt, actor_id):
        """Wait (<=30s) for an actor's executor to be live. Actor
        creation is async; compile blocks until actors exist
        (reference: experimental_compile waits on actors)."""
        import time as _time

        deadline = _time.monotonic() + 30.0
        while _time.monotonic() < deadline:
            with rt._actor_lock:
                executor = rt._actor_executors.get(actor_id)
            if executor is not None and executor.instance is not None:
                return executor
            if actor_id in getattr(rt, "_remote_actors", {}):
                return None
            _time.sleep(0.01)
        return None

    def _bind_executors(self):
        """Channel mode iff every compute node is a sync in-process actor
        method; returns {node_id: (executor, bound_method_name)}."""
        from ray_tpu_torch._private import worker

        rt = worker.global_runtime()
        if rt is None:
            return None
        bound = {}
        for node in self.schedule:
            if isinstance(node, (InputNode, MultiOutputNode)):
                continue
            if not isinstance(node, ClassMethodNode):
                return None         # task node: dynamic fallback
            actor_id = node.actor_handle._actor_id
            if actor_id in rt._remote_actors:
                return None         # daemon-hosted actor
            executor = self._resolve_live_executor(rt, actor_id)
            if executor is None or executor.is_async:
                return None
            instance = executor.instance
            from ray_tpu_torch._private.cluster import RemoteActorInstance
            from ray_tpu_torch._private.worker_process import \
                _ProcessActorInstance
            if isinstance(instance,
                          (_ProcessActorInstance, RemoteActorInstance)):
                # worker-process / daemon-hosted actor: fallback. The
                # instance check matters even with the _remote_actors
                # gate above — actor creation is async, so a compile
                # racing registration can resolve the executor first.
                return None
            bound[node.id] = executor
        return bound or None

    def _bind_process_channels(self):
        """Cross-process channel mode iff every compute node is a
        method on a DRIVER-SPAWNED process-worker actor: pre-allocate
        one shm channel per consumed edge, ship each actor ONE
        dag_start op binding its stages to channels, and let values
        flow worker->worker through shared memory from then on
        (reference: shared_memory_channel.py + _do_exec_tasks loop)."""
        from ray_tpu_torch._private import worker
        from ray_tpu_torch._private.worker_process import _ProcessActorInstance
        from ray_tpu_torch.dag.shm_channel import ShmChannel

        rt = worker.global_runtime()
        if rt is None:
            return None

        # every compute node must resolve to a live process-actor client
        instances = {}
        for node in self.schedule:
            if isinstance(node, (InputNode, MultiOutputNode)):
                continue
            if not isinstance(node, ClassMethodNode):
                return None
            actor_id = node.actor_handle._actor_id
            if actor_id in getattr(rt, "_remote_actors", {}):
                return None          # daemon-hosted: no direct client
            executor = self._resolve_live_executor(rt, actor_id)
            if executor is None:
                return None
            if not isinstance(executor.instance, _ProcessActorInstance):
                return None
            instances[node.id] = (actor_id, executor.instance)
        actor_instances = {aid: inst for aid, inst in instances.values()}

        if not instances:
            return None
        # every stage must be GATED by a channel read (a node with only
        # constant args would free-run in the worker loop, executing
        # more rounds than execute() calls — a semantic break for
        # stateful actors), and constants must not be ObjectRefs (the
        # dynamic path resolves those; channels would ship raw handles)
        from ray_tpu_torch._private.object_ref import ObjectRef as _Ref
        has_input = any(isinstance(n, InputNode) for n in self.schedule)
        if not has_input:
            return None
        for node in self.schedule:
            if isinstance(node, (InputNode, MultiOutputNode)):
                continue
            srcs = list(node.args) + list(node.kwargs.values())
            if not any(isinstance(a, DAGNode) for a in srcs):
                return None
            if any(isinstance(a, _Ref) for a in srcs):
                return None

        # one channel per CONSUMED edge (fan-out = one channel per
        # consumer; a node using the same upstream twice gets two)
        channels = {}                 # channel name -> ShmChannel (owner)
        input_feeds = []              # channels the driver writes args to
        consts: list = []
        stage_specs: Dict[Any, list] = {}   # actor_id -> [stage...]
        out_edges: Dict[int, list] = {}     # producer node id -> names

        def new_channel():
            ch = ShmChannel(create=True, capacity=self._buffer_size)
            channels[ch.name] = ch
            return ch

        def source_for(arg):
            if isinstance(arg, InputNode):
                ch = new_channel()
                input_feeds.append(ch)
                return ("chan", ch.name)
            if isinstance(arg, DAGNode):
                ch = new_channel()
                out_edges.setdefault(arg.id, []).append(ch.name)
                return ("chan", ch.name)
            consts.append(arg)
            return ("const", len(consts) - 1)

        for node in self.schedule:
            if isinstance(node, (InputNode, MultiOutputNode)):
                continue
            spec = {
                "method": node.method_name,
                "args": [source_for(a) for a in node.args],
                "kwargs": {k: source_for(v)
                           for k, v in node.kwargs.items()},
                "out": [],            # filled below once consumers known
            }
            actor_id, _ = instances[node.id]
            stage_specs.setdefault(actor_id, []).append((node.id, spec))

        # driver-read output channels (the DAG's results)
        roots = (self.root.args if isinstance(self.root, MultiOutputNode)
                 else [self.root])
        if any(not isinstance(r, ClassMethodNode) for r in roots):
            # e.g. a MultiOutputNode echoing the InputNode directly: no
            # stage would ever write that output channel — dynamic path
            for ch in channels.values():
                ch.close()
                ch.unlink()
            return None
        outputs = []
        for out_node in roots:
            ch = new_channel()
            out_edges.setdefault(out_node.id, []).append(ch.name)
            outputs.append(ch)

        for actor_id, stages in stage_specs.items():
            for node_id, spec in stages:
                spec["out"] = out_edges.get(node_id, [])

        # bind each actor's loop with ONE RPC; per-actor channel set
        # and per-actor consts (no shipping one stage's big constant to
        # every worker). A GENERATION token scopes teardown: a stale
        # CompiledDAG being GC'd must not kill a newer binding.
        import uuid

        gen = uuid.uuid4().hex
        started = []

        def send_stop(instance):
            try:
                instance._client.dag_op("dag_stop", gen)
            except Exception:
                pass

        try:
            for actor_id, stages in stage_specs.items():
                instance = actor_instances[actor_id]
                names = set()
                used_consts = []
                for _, spec in stages:
                    for part in (spec["args"],
                                 list(spec["kwargs"].values())):
                        for i, (kind, key) in enumerate(part):
                            if kind == "chan":
                                names.add(key)
                            else:
                                used_consts.append(key)
                    names.update(spec["out"])
                remap = {old: i for i, old in
                         enumerate(dict.fromkeys(used_consts))}

                def remap_src(src):
                    kind, key = src
                    return (kind, key if kind == "chan" else remap[key])

                actor_stages = [
                    {"method": spec["method"],
                     "args": [remap_src(s) for s in spec["args"]],
                     "kwargs": {k: remap_src(s)
                                for k, s in spec["kwargs"].items()},
                     "out": spec["out"]}
                    for _, spec in stages]
                outcome = instance._client.dag_op("dag_start", {
                    "channels": sorted(names),
                    "consts": [consts[old] for old in remap],
                    "stages": actor_stages,
                    "gen": gen,
                })
                if outcome[0] not in ("ok", "ok_raw"):
                    raise RuntimeError(
                        f"dag_start failed on actor {actor_id}: "
                        f"{outcome}")
                started.append(instance)
        except Exception:
            for instance in started:   # stop loops already bound
                send_stop(instance)
            for ch in channels.values():
                ch.close()
                ch.unlink()
            raise

        proc = {"channels": channels, "inputs": input_feeds,
                "outputs": outputs, "actors": started, "gen": gen,
                "stop": send_stop}
        self._start_finisher(proc)
        return proc

    def execute(self, *args):
        if self._teardown:
            raise RuntimeError("compiled DAG was torn down")
        if self._executors is not None:
            return self._execute_channels(args)
        if self._proc is not None:
            return self._execute_process(args)
        return _run_schedule(self.schedule, self.root, args)

    def _start_finisher(self, proc) -> None:
        """ONE long-lived reader drains the output channels in round
        order — concurrent execute() calls enqueue rounds instead of
        racing multiple readers on the single-consumer channels."""
        import queue
        import threading

        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch._private import worker

        rounds: "queue.Queue" = queue.Queue()
        proc["rounds"] = rounds
        outputs = proc["outputs"]

        def read_output(ch):
            # short-poll reads + liveness checks: a DEAD stage worker
            # must fail the round promptly, not after a 300s channel
            # timeout
            deadline = 300
            waited = 0.0
            while True:
                try:
                    return ch.read(timeout=2.0)
                except TimeoutError:
                    waited += 2.0
                    for instance in proc["actors"]:
                        if instance._client.dead:
                            raise exc.ActorDiedError(
                                None, "compiled-DAG stage worker died")
                    if waited >= deadline:
                        raise

        def run():
            rt = worker.global_runtime()
            while True:
                item = rounds.get()
                if item is None:
                    return
                oid, multi = item
                try:
                    got = [read_output(ch) for ch in outputs]
                    err = next((v for s, v in got if s != "ok"), None)
                    if err is not None:
                        raise err
                    vals = [v for _, v in got]
                    rt._store_value(oid, vals if multi else vals[0])
                except BaseException as e:  # noqa: BLE001 — to the ref
                    rt._store_value(oid, exc.TaskError(e, "compiled_dag"))
                rt.futures.complete(oid)

        t = threading.Thread(target=run, daemon=True,
                             name="compiled-dag-finisher")
        proc["finisher"] = t
        t.start()

    def _execute_process(self, args):
        from ray_tpu_torch._private import worker
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef

        rt = worker.global_worker()
        value = None
        if self._proc["inputs"]:
            if not args:
                raise ValueError("DAG has an InputNode but execute() "
                                 "got no argument")
            value = args[0]
            if isinstance(value, ObjectRef):
                value = rt.get([value])[0]

        oid = ObjectID.from_random()
        ref = ObjectRef(oid, owner_hex=rt.worker_id.hex(),
                        task_name="compiled_dag")
        with self._submit_lock:
            for ch in self._proc["inputs"]:
                ch.write("ok", value)
            self._proc["rounds"].put(
                (oid, isinstance(self.root, MultiOutputNode)))
        return ref

    def _execute_channels(self, args):
        import threading

        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch._private import worker
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef

        rt = worker.global_worker()
        slots = {node.id: _Slot() for node in self.schedule}

        def read(arg):
            if isinstance(arg, DAGNode):
                return slots[arg.id].get()
            if isinstance(arg, ObjectRef):
                # parity with the dynamic path: refs resolve to values
                return rt.get([arg])[0]
            return arg

        for node in self.schedule:
            if isinstance(node, InputNode):
                if not args:
                    raise ValueError("DAG has an InputNode but execute() "
                                     "got no argument")
                value = args[0]
                if isinstance(value, ObjectRef):
                    value = rt.get([value])[0]
                slots[node.id].put(value)
            elif isinstance(node, MultiOutputNode):
                continue            # gathered by the finisher
            else:
                def op(instance, node=node):
                    slot = slots[node.id]
                    try:
                        vals = [read(a) for a in node.args]
                        kw = {k: read(v) for k, v in node.kwargs.items()}
                        method = getattr(instance, node.method_name)
                        slot.put(method(*vals, **kw))
                    except BaseException as e:  # noqa: BLE001 — to slot
                        slot.put_error(e)

                def on_dead(cause, node=node):
                    slots[node.id].put_error(exc.ActorDiedError(
                        node.actor_handle._actor_id, cause))

                if not self._executors[node.id].submit_direct(
                        op, on_dead=on_dead):
                    raise RuntimeError(
                        "compiled DAG actor is dead; rebuild the DAG")

        # The caller gets a normal ObjectRef; only the FINAL value is
        # sealed into the store (reference: execute() returns a ref).
        oid = ObjectID.from_random()
        ref = ObjectRef(oid, owner_hex=rt.worker_id.hex(),
                        task_name="compiled_dag")

        def finish():
            try:
                if isinstance(self.root, MultiOutputNode):
                    value = [slots[o.id].get() for o in self.root.args]
                else:
                    value = slots[self.root.id].get()
                rt._store_value(oid, value)
            except BaseException as e:  # noqa: BLE001 — shipped to ref
                rt._store_value(oid, exc.TaskError(e, "compiled_dag"))
            rt.futures.complete(oid)

        threading.Thread(target=finish, daemon=True,
                         name="compiled-dag-finish").start()
        return ref

    def __del__(self):
        try:
            if not self._teardown and self._proc is not None:
                self.teardown()
        except Exception:
            pass

    def teardown(self) -> None:
        self._teardown = True
        if self._proc is not None:
            for instance in self._proc["actors"]:
                self._proc["stop"](instance)   # generation-scoped stop
            self._proc["rounds"].put(None)     # drain the finisher
            self._proc["finisher"].join(timeout=5)
            for ch in self._proc["channels"].values():
                ch.close()
                ch.unlink()
            self._proc = None
