"""Length-prefixed framing over a stream socket (counterpart of the framing
helpers of ``ray_tpu/_private/rpc.py``).

The fast lane (``_private/fast_lane.py``) reads and writes its frames with
these, as JAX's does with its own. The daemons' ``Client``/``Server`` RPC and
its wire format come with the daemons.
"""

from __future__ import annotations

import socket
import struct

_LEN = struct.Struct("!I")
MAX_FRAME = 1 << 31


class RpcError(Exception):
    """Transport-level failure (peer died, protocol violation)."""


# Above this size the `len + blob` concatenation copy costs more than a
# second syscall: send header and payload as two sendalls under the lock
# (zero extra copy); below it, one small concat + one syscall wins.
SEND_CONCAT_MAX = 64 * 1024


def send_frame_bytes(sock: socket.socket, blob, wlock) -> None:
    """Length-prefixed frame write. ``blob`` is any bytes-like; large
    payloads are never copied into a `len + blob` concatenation. ``wlock``
    is the connection's write-serialization lock — holding it across the
    sendall is the contract (frames must not interleave)."""
    n = len(blob)
    if n > MAX_FRAME:
        raise RpcError(f"frame too large: {n}")
    if n <= SEND_CONCAT_MAX:
        with wlock:
            sock.sendall(_LEN.pack(n) + blob)
        return
    with wlock:
        # two-phase write under the same lock hold: the header and its
        # payload must stay adjacent on the stream
        sock.sendall(_LEN.pack(n))
        sock.sendall(blob)


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes via recv_into on one preallocated buffer —
    no per-chunk bytes allocation + copy. Raises ConnectionError on EOF (an
    OSError subclass, so transport-failure handling catches it
    unchanged)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("connection closed")
        got += r
    return buf
