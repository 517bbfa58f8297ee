"""Length-prefixed frames shared by the client and the server (counterpart
of ``ray_tpu/util/client/protocol.py``): each frame is one value dumped by
the port's by-value pickler with its tensor reducer
(``device_objects.wire_dumps``), where JAX's uses cloudpickle."""

from __future__ import annotations

import socket
import struct
from typing import Any

from ray_tpu_torch._private.device_objects import wire_dumps, wire_loads
from ray_tpu_torch._private.rpc import SEND_CONCAT_MAX
from ray_tpu_torch._private.rpc import recv_exact as _recv_exact

_HDR = struct.Struct("!Q")
MAX_FRAME = 1 << 34


def send_msg(sock: socket.socket, obj: Any) -> None:
    payload = wire_dumps(obj)
    if len(payload) <= SEND_CONCAT_MAX:
        sock.sendall(_HDR.pack(len(payload)) + payload)
    else:   # large arrays: no header+payload concatenation copy
        sock.sendall(_HDR.pack(len(payload)))
        sock.sendall(payload)


def recv_msg(sock: socket.socket) -> Any:
    (length,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return wire_loads(_recv_exact(sock, length))
