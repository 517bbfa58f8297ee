"""Value serialization with out-of-band buffers (counterpart of
``ray_tpu/_private/serialization.py``).

The stdlib ``pickle`` (protocol 5) with out-of-band buffers for zero-copy
numpy payloads, a registry of custom serializers, and in-band ObjectRef
capture so references nested inside values keep their identity across the
store boundary.

Where the reference uses ``cloudpickle``, the port has its own by-value
pickler on ``pickle.Pickler.reducer_override`` (:class:`ByValuePickler`),
because the card's machine has no ``cloudpickle``. It gives a worker process
what ``cloudpickle`` gives JAX's wire:

- a function or class that cannot be imported by its module and qualified
  name (defined in ``__main__``, in a function body, or a lambda) goes by
  value: its code through ``marshal``, the globals its code names, its
  closure values, defaults and ``__dict__``; a class as its name, bases,
  metaclass and members. A class keeps one identity per process across
  pickles (a tracker id), so an instance that goes to a worker and back is
  still an instance of the driver's class;
- everything importable goes by reference, as the stdlib pickles it;
- modules go by name.

What the stdlib cannot carry (a lock, an open file, a generator) still
raises; the process router then runs the task in the driver, JAX's own path
for a value ``cloudpickle`` refuses.

Tensors: the pickler of :class:`SerializationContext` carries a
``torch.Tensor`` or ``DTensor`` through the wire format of
:mod:`ray_tpu_torch._private.device_objects`.
"""

from __future__ import annotations

import abc
import builtins
import dataclasses
import dis
import enum
import importlib
import io
import marshal
import pickle
import sys
import threading
import types
import uuid
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import device_objects
from ray_tpu_torch._private.object_ref import ObjectRef


# ---------------------------------------------------------------------------
# by-value pickling of functions and classes
# ---------------------------------------------------------------------------

_GLOBAL_OPS = frozenset(dis.opmap[name] for name in
                        ("LOAD_GLOBAL", "STORE_GLOBAL", "DELETE_GLOBAL")
                        if name in dis.opmap)

_CODE_GLOBALS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_CODE_GLOBALS_LOCK = threading.Lock()

# class identity across pickles: the same tracker id rebuilds as the same
# class object in one process (cloudpickle's _DYNAMIC_CLASS_TRACKER)
_CLASS_TRACKER_BY_CLASS: "weakref.WeakKeyDictionary" = \
    weakref.WeakKeyDictionary()
_CLASS_BY_TRACKER: "weakref.WeakValueDictionary" = \
    weakref.WeakValueDictionary()
_CLASS_TRACKER_LOCK = threading.Lock()
# skeletons built by this process whose members are still to be set: a
# class that is already known keeps its own members
_FRESH_SKELETONS: "weakref.WeakSet" = weakref.WeakSet()


_HEAPTYPE = 1 << 9     # Py_TPFLAGS_HEAPTYPE: a class made by a class statement


class _EmptyCell:
    """Marks a closure cell that had no value when its function was
    pickled."""


def _code_globals(code: types.CodeType) -> frozenset:
    """Names the code (and every code object nested in it) reads or writes
    as globals."""
    with _CODE_GLOBALS_LOCK:
        cached = _CODE_GLOBALS.get(code)
    if cached is not None:
        return cached
    names = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for ins in dis.get_instructions(co):
            if ins.opcode in _GLOBAL_OPS:
                names.add(ins.argval)
        stack.extend(c for c in co.co_consts
                     if isinstance(c, types.CodeType))
    out = frozenset(names)
    with _CODE_GLOBALS_LOCK:
        _CODE_GLOBALS[code] = out
    return out


def _getattr_path(obj: Any, qualname: str) -> Any:
    for part in qualname.split("."):
        if part == "<locals>":
            raise AttributeError(qualname)
        obj = getattr(obj, part)
    return obj


def importable_by_reference(obj: Any) -> bool:
    """True if ``obj`` is found again under its module and qualified name,
    so that the stdlib's by-reference pickle reaches the same object in
    another process."""
    name = getattr(obj, "__qualname__", None) or getattr(obj, "__name__",
                                                          None)
    if name is None:
        return False
    module_name = getattr(obj, "__module__", None)
    if module_name is None:
        module_name = pickle.whichmodule(obj, name)
    if module_name == "__main__":
        return False
    module = sys.modules.get(module_name)
    if module is None:
        return False
    try:
        return _getattr_path(module, name) is obj
    except AttributeError:
        return False


def _make_function(code_bytes: bytes, globals_: Dict[str, Any], name: str,
                   nfree: int) -> types.FunctionType:
    globals_.setdefault("__builtins__", builtins)
    closure = (tuple(types.CellType() for _ in range(nfree))
               if nfree else None)
    return types.FunctionType(marshal.loads(code_bytes), globals_, name,
                              None, closure)


def _function_setstate(func: types.FunctionType, state: tuple) -> None:
    (f_globals, defaults, kwdefaults, f_dict, closure_values, qualname,
     module, doc, annotations) = state
    func.__globals__.update(f_globals)
    func.__defaults__ = defaults
    func.__kwdefaults__ = kwdefaults
    func.__dict__.update(f_dict)
    for cell, value in zip(func.__closure__ or (), closure_values):
        if value is not _EmptyCell:
            cell.cell_contents = value
    func.__qualname__ = qualname
    func.__module__ = module
    func.__doc__ = doc
    func.__annotations__ = annotations


def _class_tracker_id(cls: type) -> str:
    with _CLASS_TRACKER_LOCK:
        tid = _CLASS_TRACKER_BY_CLASS.get(cls)
        if tid is None:
            tid = uuid.uuid4().hex
            _CLASS_TRACKER_BY_CLASS[cls] = tid
            _CLASS_BY_TRACKER[tid] = cls
        return tid


def _make_skeleton_class(metaclass: type, name: str, bases: tuple,
                         type_kwargs: Dict[str, Any], tracker_id: str
                         ) -> type:
    with _CLASS_TRACKER_LOCK:
        known = _CLASS_BY_TRACKER.get(tracker_id)
        if known is not None:
            return known
        skeleton = types.new_class(name, bases, {"metaclass": metaclass},
                                   lambda ns: ns.update(type_kwargs))
        _CLASS_BY_TRACKER[tracker_id] = skeleton
        _CLASS_TRACKER_BY_CLASS[skeleton] = tracker_id
        _FRESH_SKELETONS.add(skeleton)
        return skeleton


def _class_setstate(cls: type, members: Dict[str, Any]) -> None:
    with _CLASS_TRACKER_LOCK:
        if cls not in _FRESH_SKELETONS:
            return
        _FRESH_SKELETONS.discard(cls)
    for attr, value in members.items():
        setattr(cls, attr, value)
    if isinstance(cls, abc.ABCMeta):
        abc.update_abstractmethods(cls)


def _mappingproxy(d: Dict[str, Any]) -> types.MappingProxyType:
    return types.MappingProxyType(d)


def _import_module(name: str) -> types.ModuleType:
    return importlib.import_module(name)


class ByValuePickler(pickle.Pickler):
    """Protocol-5 pickler that carries functions and classes by value when
    they cannot be imported by reference (the port's ``cloudpickle``)."""

    def __init__(self, file, protocol: int = 5, buffer_callback=None):
        super().__init__(file, protocol=protocol,
                         buffer_callback=buffer_callback)
        # one rebuilt globals dict per source module within one pickle, so
        # functions of one module keep seeing each other's globals
        self._globals_ref: Dict[int, Dict[str, Any]] = {}

    def reducer_override(self, obj):
        t = type(obj)
        if t is types.FunctionType:
            if importable_by_reference(obj):
                return NotImplemented
            return self._function_reduce(obj)
        if isinstance(obj, type):
            if (not obj.__flags__ & _HEAPTYPE
                    or importable_by_reference(obj)):
                return NotImplemented
            return self._class_reduce(obj)
        if t is types.ModuleType:
            name = obj.__name__
            if name == "__main__" or sys.modules.get(name) is not obj:
                raise pickle.PicklingError(
                    f"cannot pickle dynamic module {name!r}")
            return (_import_module, (name,))
        if t is types.CodeType:
            return (marshal.loads, (marshal.dumps(obj),))
        if t is classmethod or t is staticmethod:
            return (t, (obj.__func__,))
        if t is property:
            return (property, (obj.fget, obj.fset, obj.fdel, obj.__doc__))
        if t is types.MappingProxyType:
            return (_mappingproxy, (dict(obj),))
        if t is dataclasses._FIELD_BASE:
            # the field-kind sentinels are compared by identity
            return (getattr, (dataclasses, obj.name))
        if obj is dataclasses.MISSING:
            return (getattr, (dataclasses, "MISSING"))
        return NotImplemented

    def _function_reduce(self, func: types.FunctionType):
        code = func.__code__
        f_globals_all = func.__globals__
        base = self._globals_ref.setdefault(id(f_globals_all), {})
        f_globals = {k: f_globals_all[k] for k in _code_globals(code)
                     if k in f_globals_all}
        closure_values = []
        for cell in func.__closure__ or ():
            try:
                closure_values.append(cell.cell_contents)
            except ValueError:
                closure_values.append(_EmptyCell)
        state = (f_globals, func.__defaults__, func.__kwdefaults__,
                 dict(func.__dict__), closure_values, func.__qualname__,
                 func.__module__, func.__doc__,
                 dict(getattr(func, "__annotations__", None) or {}))
        # the function is memoized before its state is pickled, so a
        # recursive function (through its globals or a closure cell) and
        # mutually recursive ones resolve to the rebuilt objects
        return (_make_function,
                (marshal.dumps(code), base, func.__name__,
                 len(code.co_freevars)),
                state, None, None, _function_setstate)

    def _class_reduce(self, cls: type):
        if issubclass(cls, enum.Enum):
            raise pickle.PicklingError(
                f"enum class {cls.__qualname__} cannot be pickled by value")
        members = dict(cls.__dict__)
        for name in ("__dict__", "__weakref__", "_abc_impl"):
            members.pop(name, None)
        type_kwargs: Dict[str, Any] = {}
        slots = members.get("__slots__")
        if slots is not None:
            slots = [slots] if isinstance(slots, str) else list(slots)
            for s in slots:
                members.pop(s, None)
            type_kwargs["__slots__"] = tuple(slots)
            members.pop("__slots__", None)
        return (_make_skeleton_class,
                (type(cls), cls.__name__, cls.__bases__, type_kwargs,
                 _class_tracker_id(cls)),
                members, None, None, _class_setstate)


def dumps(value: Any, buffer_callback=None) -> bytes:
    """Pickle ``value`` with the by-value pickler (protocol 5)."""
    buf = io.BytesIO()
    ByValuePickler(buf, buffer_callback=buffer_callback).dump(value)
    return buf.getvalue()


def loads(blob, buffers=None) -> Any:
    return pickle.loads(blob, buffers=buffers)


# ---------------------------------------------------------------------------
# the object store's serializer
# ---------------------------------------------------------------------------

@dataclass
class SerializedValue:
    """A pickled payload plus its out-of-band buffers and captured refs."""

    inband: bytes
    buffers: List[pickle.PickleBuffer] = field(default_factory=list)
    # ObjectRefs discovered inside the value during serialization. The owner
    # must keep these alive while the serialized copy exists (borrowed refs).
    nested_refs: List[Any] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        n = len(self.inband)
        for b in self.buffers:
            n += b.raw().nbytes
        return n


class _Pickler(ByValuePickler):
    """Records nested ObjectRefs, applies the context's custom serializers
    and carries tensors in the device-object wire format."""

    def __init__(self, buf, buffers, nested_refs, custom):
        super().__init__(buf, buffer_callback=buffers.append)
        self._nested_refs = nested_refs
        self._custom = custom

    def reducer_override(self, obj):
        if isinstance(obj, ObjectRef):
            self._nested_refs.append(obj)
            return (ObjectRef._rehydrate, (obj.id, obj.owner_hex()))
        ser = self._custom.get(type(obj))
        if ser is not None:
            serializer, deserializer = ser
            return (_apply_deserializer, (deserializer, serializer(obj)))
        if device_objects.is_tensor(obj):
            return device_objects.tensor_reduce(obj)
        return super().reducer_override(obj)


class SerializationContext:
    """Per-process serializer with custom reducer registry."""

    def __init__(self):
        self._custom_serializers: Dict[type, tuple] = {}
        self._lock = threading.Lock()

    def register_custom_serializer(self, cls: type,
                                   serializer: Callable[[Any], Any],
                                   deserializer: Callable[[Any], Any]) -> None:
        with self._lock:
            self._custom_serializers[cls] = (serializer, deserializer)

    def deregister_custom_serializer(self, cls: type) -> None:
        with self._lock:
            self._custom_serializers.pop(cls, None)

    def serialize(self, value: Any) -> SerializedValue:
        buffers: List[pickle.PickleBuffer] = []
        nested_refs: List[Any] = []
        buf = io.BytesIO()
        with self._lock:
            custom = dict(self._custom_serializers)
        _Pickler(buf, buffers, nested_refs, custom).dump(value)
        return SerializedValue(buf.getvalue(), buffers, nested_refs)

    def deserialize(self, sv: SerializedValue) -> Any:
        return pickle.loads(sv.inband, buffers=sv.buffers)


def _apply_deserializer(deserializer, payload):
    return deserializer(payload)


def check_serializable(value: Any) -> Optional[str]:
    """Return None if value serializes cleanly, else the error string."""
    try:
        SerializationContext().serialize(value)
        return None
    except Exception as e:  # noqa: BLE001 - report any failure to the user
        return f"{type(e).__name__}: {e}"
