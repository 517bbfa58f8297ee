"""Value serialization with out-of-band buffers (counterpart of
``ray_tpu/_private/serialization.py``).

The stdlib ``pickle`` (protocol 5) with out-of-band buffers for zero-copy
numpy payloads, a registry of custom serializers, and in-band ObjectRef
capture so references nested inside values keep their identity across the
store boundary. Where the reference uses ``cloudpickle``, the port uses the
stdlib pickler: functions and classes pickle by reference, as they do in
one process. CUDA tensors have no reducer here: the in-process core keeps
them in the object store's device tier and never pickles them.
"""

from __future__ import annotations

import io
import pickle
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


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


class _Pickler(pickle.Pickler):
    """Protocol-5 pickler that records nested ObjectRefs and applies the
    context's custom serializers."""

    def __init__(self, buf, buffers, nested_refs, custom):
        super().__init__(buf, protocol=5, buffer_callback=buffers.append)
        self._nested_refs = nested_refs
        self._custom = custom

    def reducer_override(self, obj):
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            self._nested_refs.append(obj)
            return (ObjectRef._rehydrate, (obj.id, obj.owner_hex()))
        ser = self._custom.get(type(obj))
        if ser is not None:
            serializer, deserializer = ser
            return (_apply_deserializer, (deserializer, serializer(obj)))
        return NotImplemented


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
