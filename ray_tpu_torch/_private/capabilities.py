"""Declared registry of hello-advertised capability bits (counterpart of
``ray_tpu/_private/capabilities.py``).

The daemon's ``handle_hello_driver`` reply advertises what it can do; the
driver stores each bit on its ``DaemonHandle`` under the bit's ``guard``
attribute and reads it there. The table is data: a test holds it against
a live hello reply and against ``DaemonHandle`` (every bit is in the reply
and its guard attribute exists).

The port's wire carries four bits. JAX's ``batch`` and ``result_batch``
bits and the frame flags ``via_pump`` and ``term_pump`` are not
advertised: the port's daemons always coalesce and always answer a classic
submit on the result pump (ROADMAP C).
"""

CAPABILITY_FLAGS = {
    "objectplane": {
        "kind": "hello",
        "guard": "objectplane",
        "doc": "daemon exposes the shm object arena (zero-copy gets)",
    },
    "async_core": {
        "kind": "hello",
        "guard": "_async_core_remote",
        "doc": "daemon runs the single-threaded asyncio wire+dispatch core "
               "(cfg().async_core). Frames are byte-identical across "
               "cores, so the bit gates nothing on the wire: it makes "
               "mixed clusters observable (describe_peers)",
    },
    "tenancy": {
        "kind": "hello",
        "guard": "_tenancy_supported",
        "doc": "daemon accepts tenancy_sync job-table frames (per-job "
               "quota/weight federation); drivers that never see the bit "
               "fall back to unconditional admission",
    },
    "fence": {
        "kind": "hello",
        "guard": "_fence_supported",
        "doc": "daemon stamps result and stream frames with its "
               "registration epoch (``ep``): the driver fences frames of "
               "a superseded incarnation after a healed partition",
    },
}
