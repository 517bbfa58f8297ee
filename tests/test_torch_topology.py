"""The port's torus model and accelerator detection, held to JAX's.

JAX's four topology tests (``tests/test_parallel.py``) run on
``ray_tpu_torch.parallel``; one seeded sequence of ``allocate``, ``free``
and ``max_hosts`` calls on v4, v5p, v5e and v6e slices gives the same boxes
on both packages; ``detect_local_topology`` reads the same pod variables
and keeps JAX's single-host fallback (the port counts CUDA cards where JAX
counts its TPU devices, so one card gives None); and the accelerator
functions read the same environment, with ``GPU`` where JAX names ``TPU``.
"""

import numpy as np
import pytest

from ray_tpu._private import accelerators as jax_acc
from ray_tpu.parallel import topology as jax_topo
from ray_tpu_torch._private import accelerators as acc
from ray_tpu_torch.parallel import (SubSlice, TpuTopology,
                                    detect_local_topology, parse_topology)
from ray_tpu_torch.parallel import topology as port_topo


# -- JAX's four tests, on the port ------------------------------------------

def test_topology_basics():
    topo = TpuTopology("v5p", "4x4x4")
    assert topo.num_chips == 64
    assert topo.num_hosts == 16
    assert topo.chips_per_host == 4


def test_topology_subslice_allocation():
    topo = TpuTopology("v5p", "4x4x4")
    sub = topo.allocate(8)
    assert sub is not None and sub.num_chips == 8
    # cube-like preference: 2x2x2
    assert sorted(sub.shape) == [2, 2, 2]
    a = topo.allocate(32)
    b = topo.allocate(16)
    assert a is not None and b is not None
    assert topo.allocate(32) is None  # only 8 chips left
    topo.free(a)
    assert topo.allocate(32) is not None


def test_topology_v5e_2d():
    topo = TpuTopology("v5e", "4x4")
    assert topo.num_chips == 16
    assert topo.num_hosts == 4
    sub = topo.allocate(4)
    assert sub.num_chips == 4
    with pytest.raises(ValueError):
        TpuTopology("v5e", "4x4x4")  # wrong dimensionality


def test_topology_host_mapping():
    topo = TpuTopology("v5e", "4x4")
    hosts = {topo.host_of(c.coords) for c in topo.chips()}
    assert hosts == {0, 1, 2, 3}
    sub = topo.allocate(4)  # one host block 2x2
    assert len(topo.hosts_of_subslice(sub)) == 1


# -- the allocator against JAX's ---------------------------------------------

def _box(sub):
    return None if sub is None else (tuple(sub.origin), tuple(sub.shape))


def _drive(mod, gen, spec, seed, steps=60):
    """One seeded sequence of allocations (sizes, ``max_hosts`` and an
    ``accept`` that vetoes boxes at an odd first coordinate) and frees on
    ``mod``'s allocator; the box of each call, and the chips and hosts of
    each box, in order."""
    rng = np.random.default_rng(seed)
    topo = mod.TpuTopology(gen, spec)
    sizes = [n for n in (1, 2, 3, 4, 6, 8, 12, 16, 32)
             if n <= topo.num_chips]
    live, trace = [], []
    for _ in range(steps):
        if live and rng.random() < 0.3:
            sub = live.pop(int(rng.integers(len(live))))
            topo.free(sub)
            trace.append(("free", _box(sub)))
            continue
        n = sizes[int(rng.integers(len(sizes)))]
        max_hosts = [None, 1, 2][int(rng.integers(3))]
        veto = rng.random() < 0.25
        sub = topo.allocate(
            n, max_hosts=max_hosts,
            accept=(lambda c: c.origin[0] % 2 == 0) if veto else None)
        if sub is not None:
            live.append(sub)
            trace.append(("alloc", n, max_hosts, veto, _box(sub),
                          sub.chips(), topo.hosts_of_subslice(sub)))
        else:
            trace.append(("alloc", n, max_hosts, veto, None))
    return trace


@pytest.mark.parametrize("gen,spec", [("v4", "2x2x4"), ("v4", "4x4x4"),
                                      ("v5p", "2x4x4"), ("v5e", "4x4"),
                                      ("v5litepod", "2x4"), ("v6e", "8x8"),
                                      ("v6e", "4x8")])
def test_allocator_gives_jax_boxes(gen, spec):
    """The same calls give the same boxes, in the same order, on both
    packages (the boxes are the most cube-like first fit; a veto moves the
    search on to the next origin or shape)."""
    kinds = set()
    for seed in range(3):
        port = _drive(port_topo, gen, spec, seed)
        assert port == _drive(jax_topo, gen, spec, seed)
        kinds |= {(t[0], t[0] == "alloc" and t[4] is None) for t in port}
    # the sequences placed, refused and freed
    assert kinds == {("alloc", False), ("alloc", True), ("free", False)}


@pytest.mark.parametrize("gen,spec", [("v5p", "2x2x4"), ("v6e", "4x4")])
def test_manager_binds_and_allocates_as_jax(gen, spec):
    """The manager's binding (first seen, stable; an unbound host is taken
    again by the next new node) and its chips by host match JAX's."""
    outs = []
    for mod in (port_topo, jax_topo):
        mgr = mod.TpuTopologyManager.from_spec(f"{gen}:{spec}")
        mgr.bind_nodes(["a", "b", "c"])
        mgr.bind_nodes(["b", "d"])
        mgr.unbind_node("b")
        mgr.bind_nodes(["e"])
        hosts = [mgr.node_of_host(h) for h in range(mgr.topology.num_hosts)]
        sub = mgr.allocate(8)
        by_host = mgr.chips_by_host(sub)
        mgr.free(sub)
        outs.append((hosts, _box(sub), by_host, mgr.topology._allocated))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="want '<gen>:<AxBxC>'"):
        port_topo.TpuTopologyManager.from_spec("v5p")


def test_parse_topology_and_subslice_as_jax():
    assert parse_topology("4x4X2") == jax_topo.parse_topology("4x4X2")
    for bad in ("4xa", "0x4", ""):
        with pytest.raises(ValueError):
            parse_topology(bad)
        with pytest.raises(ValueError):
            jax_topo.parse_topology(bad)
    sub = SubSlice((1, 0, 2), (2, 2, 1))
    ref = jax_topo.SubSlice((1, 0, 2), (2, 2, 1))
    assert sub.chips() == ref.chips() and sub.num_chips == ref.num_chips
    assert sub.contains((2, 1, 2)) and not sub.contains((0, 0, 2))
    assert repr(TpuTopology("v4", "4x4x8")) == repr(
        jax_topo.TpuTopology("v4", "4x4x8"))
    with pytest.raises(ValueError, match="unknown TPU generation"):
        TpuTopology("h100", "2x2")
    with pytest.raises(ValueError, match="not divisible"):
        TpuTopology("v5p", "3x2x2")


# -- detection ---------------------------------------------------------------

class _Dev:
    def __init__(self, platform, kind="TPU v5 lite"):
        self.platform = platform
        self.device_kind = kind


def _pretend_devices(monkeypatch, n, name="NVIDIA H100 80GB HBM3"):
    """``n`` CUDA cards for the port and ``n`` TPU chips (and a CPU) for
    JAX's ``jax.devices()``."""
    import jax
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev("cpu")] + [
        _Dev("tpu") for _ in range(n)])


def _topo_key(t):
    return None if t is None else (t.generation, t.dims, t.num_hosts)


@pytest.mark.parametrize("acc_type,topo", [("v5p-64", "4x4x4"),
                                           ("v4-32", "2x2x4"),
                                           ("v6e-16", "4x4"),
                                           ("v5p-8", "4x4"),   # wrong dims
                                           ("h100-8", "2x4")])
def test_detect_local_topology_from_the_pod_variables(monkeypatch, acc_type,
                                                      topo):
    """``TPU_ACCELERATOR_TYPE`` and ``TPU_TOPOLOGY`` give JAX's slice; a
    spec that does not form one falls through to the devices (none here)."""
    _pretend_devices(monkeypatch, 0)
    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", acc_type)
    monkeypatch.setenv("TPU_TOPOLOGY", topo)
    got = _topo_key(detect_local_topology())
    assert got == _topo_key(jax_topo.detect_local_topology())
    assert (got is None) == (acc_type in ("v5p-8", "h100-8"))


@pytest.mark.parametrize("n", [0, 1, 2, 4, 8])
def test_detect_local_topology_single_host_fallback(monkeypatch, n):
    """JAX's fallback, with the cards counted: 4 and 8 devices model a flat
    v5e slice; one device raises inside (1x1 is no whole host block) and
    gives None, as one TPU chip does in JAX; other counts give None."""
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.delenv("TPU_TOPOLOGY", raising=False)
    _pretend_devices(monkeypatch, n)
    got = _topo_key(detect_local_topology())
    assert got == _topo_key(jax_topo.detect_local_topology())
    assert got == {4: ("v5e", (2, 2), 1), 8: ("v5e", (4, 2), 2)}.get(n)


def test_one_card_detects_no_topology(monkeypatch):
    """One H100: no slice, however the card is named."""
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.delenv("TPU_TOPOLOGY", raising=False)
    _pretend_devices(monkeypatch, 1)
    assert detect_local_topology() is None


def test_accelerator_detection_env(monkeypatch):
    """JAX's ``tests/test_util_extras.py`` test, ``GPU`` for ``TPU``."""
    monkeypatch.setenv(acc.TPU_VISIBLE_CHIPS_ENV, "0,1,2,3")
    monkeypatch.setenv(acc.TPU_ACCELERATOR_TYPE_ENV, "v5p-8")
    assert acc.detect_tpu_chips() == 4
    res = acc.accelerator_resources()
    assert res["GPU"] == 4.0
    assert "accelerator_type:v5p-8" in res


@pytest.mark.parametrize("env", [
    {"TPU_VISIBLE_CHIPS": "0,1,2,3", "TPU_ACCELERATOR_TYPE": "v5p-8",
     "TPU_WORKER_ID": "3", "TPU_NAME": "pod-a"},
    {"TPU_VISIBLE_CHIPS": "2, ,5,", "TPU_WORKER_ID": "0"},
    {"TPU_ACCELERATOR_TYPE": "v6e-16"},
    {}])
def test_accelerators_read_the_environment_as_jax(monkeypatch, env):
    """The same pod variables through both packages give the same chips,
    type, pod name, worker id and resources (the chip key aside); with no
    variable, the devices: n TPU chips for JAX, n cards for the port."""
    for var in (acc.TPU_VISIBLE_CHIPS_ENV, acc.TPU_ACCELERATOR_TYPE_ENV,
                acc.TPU_WORKER_ID_ENV, acc.TPU_NAME_ENV):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _pretend_devices(monkeypatch, 2, name="TPU v5 lite")
    port = (acc.detect_tpu_chips(), acc.get_accelerator_type(),
            acc.get_pod_name(), acc.get_worker_id(),
            acc.accelerator_resources())
    ref = (jax_acc.detect_tpu_chips(), jax_acc.get_accelerator_type(),
           jax_acc.get_pod_name(), jax_acc.get_worker_id(),
           {("GPU" if k == "TPU" else k): v
            for k, v in jax_acc.accelerator_resources().items()})
    assert port == ref


def test_card_name_gives_the_accelerator_type(monkeypatch):
    """With no pod variable the type is JAX's rule on the first card's
    name: lower case, spaces dropped, ``-{count}``."""
    for var in (acc.TPU_VISIBLE_CHIPS_ENV, acc.TPU_ACCELERATOR_TYPE_ENV):
        monkeypatch.delenv(var, raising=False)
    _pretend_devices(monkeypatch, 1)
    assert acc.detect_tpu_chips() == 1
    assert acc.get_accelerator_type() == "nvidiah10080gbhbm3-1"
    assert acc.accelerator_resources() == {
        "GPU": 1.0, "accelerator_type:nvidiah10080gbhbm3-1": 1.0}
    _pretend_devices(monkeypatch, 0)
    assert acc.accelerator_resources() == {}
    assert acc.get_accelerator_type() is None


def test_visible_chips_scope_the_process(monkeypatch):
    monkeypatch.setenv(acc.TPU_VISIBLE_CHIPS_ENV, "")   # restored after
    acc.set_visible_chips([1, 3])
    assert acc.detect_tpu_chips() == 2
    jax_acc.set_visible_chips([1, 3])
    assert jax_acc.detect_tpu_chips() == 2


def test_util_tpu_reexports():
    from ray_tpu.util import tpu as jax_tpu
    from ray_tpu_torch.util import tpu
    assert tpu.__all__ == jax_tpu.__all__
    assert tpu.TpuTopology is TpuTopology
    assert tpu.detect_tpu_chips is acc.detect_tpu_chips


def test_every_jax_module_has_a_counterpart():
    """With the topology layer every ``.py`` file of ``ray_tpu/`` has one of
    the same path in ``ray_tpu_torch/``, except two that need none:
    ``_private/process_pool.py`` (nothing in JAX's package uses it) and
    ``_private/native_build.py`` (the port's ``_build.py`` builds its
    native sources)."""
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    jax_root, port_root = repo / "ray_tpu", repo / "ray_tpu_torch"
    missing = {f.relative_to(jax_root).as_posix()
               for f in jax_root.rglob("*.py")
               if not (port_root / f.relative_to(jax_root)).exists()}
    assert missing == {"_private/process_pool.py",
                       "_private/native_build.py"}
