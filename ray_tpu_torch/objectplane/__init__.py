"""Zero-copy object plane: the cross-process data path of one node
(counterpart of ``ray_tpu/objectplane/``).

A node-level store that every process of the node maps (the daemon's
``native_store.ShmObjectStore`` arena, ``csrc/shm_store.cc``), plus
proactive node-to-node transfer with dedup.

Three pieces:

- :mod:`~ray_tpu_torch.objectplane.tiers`: the explicit
  (host-shm | device-hbm | spilled) tier model and its metrics
  (``ray_tpu_object_store_bytes{tier}``,
  ``ray_tpu_object_zero_copy_gets_total``);
- :mod:`~ray_tpu_torch.objectplane.arena`: worker-side attach to the node
  daemon's arena: read-only ``np.frombuffer`` views with a process-shared
  per-object ref/release protocol (eviction can never unmap a buffer a
  worker still views), and direct puts that reserve and write arena space
  in place (only a seal message crosses the wire);
- :mod:`~ray_tpu_torch.objectplane.push`: ``PushManager``, proactive
  daemon-to-daemon pushes of hot objects, deduplicated in flight and
  against the owner's object directory, chunks read straight from the
  arena.
"""

from ray_tpu_torch.objectplane.tiers import (TIER_DEVICE,  # noqa: F401
                                             TIER_HOST, TIER_SPILLED)
from ray_tpu_torch.objectplane.arena import (WorkerArena,  # noqa: F401
                                             configure, get_arena,
                                             sweep_stale_segments)
from ray_tpu_torch.objectplane.push import (PushManager,  # noqa: F401
                                            PushReceiver)
