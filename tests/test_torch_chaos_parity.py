"""Parity of the port's chaos modules with JAX's: one script runs on both
packages from the same seeds, and the results are compared exactly.

- the same spec string gives the same arms from ``failpoints.parse_spec``;
- the same seed and the same sequence of ``fire`` calls give the same hit
  logs and fire counts;
- the same link policy and seed give the same sequence of netchaos
  verdicts and delays;
- ``RetryPolicy`` with a seeded RNG gives the same backoffs;
- ``pressure.compute_level`` gives the same level over a grid of host,
  arena and spill fractions.

Registries are built directly (never the module-global ones), so nothing
here arms a seam of either runtime.
"""

import importlib
import random

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")

FAILPOINT_SPECS = [
    "a.b=drop:every=2:max=2;c.d=delay(1);e.f=error(OSError):after=1;"
    "g.h=return(42)",
    "rpc.client.send=drop:p=0.3;daemon.push_task=delay(5):p=0.5:max=4;"
    "pressure.level=return(hard):after=2:every=3",
    "x=return((1, 'a:b', [2])):max=1;y=crash:p=0.0;z=error",
]

NETCHAOS_SPECS = [
    "driver>daemon=lat=5:jitter=3:dup=0.25",
    "driver>daemon@lane=drop=0.3:bw=1000000;daemon>head=partition:"
    "start=50:dur=200",
    "*>daemon=flap=20/30:drop=0.5:sym",
]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}._private.{name}")


def _arm_fields(arm):
    return (arm.name, arm.action, arm.arg, arm.p, arm.every, arm.after,
            arm.max_fires)


@pytest.mark.parametrize("spec", FAILPOINT_SPECS)
def test_parse_spec_gives_the_same_arms(spec):
    got = {pkg: [_arm_fields(a) for a in _mod(pkg, "failpoints")
                 .parse_spec(spec)] for pkg in PACKAGES}
    assert got["ray_tpu"] == got["ray_tpu_torch"]
    assert got["ray_tpu"]       # the spec parsed to arms at all


def _fire_script(pkg, spec, seed):
    fp = _mod(pkg, "failpoints")
    reg = fp.Registry(seed)
    for arm in fp.parse_spec(spec):
        if arm.action in ("crash", "error"):
            continue        # effects that leave the script
        arm.arg = 0.0 if arm.action == "delay" else arm.arg
        reg.install(arm)
    outcomes = []
    names = sorted(reg.describe())
    for i in range(60):
        name = names[i % len(names)]
        out = reg.fire(name, i=i)
        outcomes.append("drop" if out is fp.DROP else
                        ("return", out.value) if isinstance(out, fp.Return)
                        else None)
    log = [{k: v for k, v in e.items() if k != "ts"} for e in reg.log()]
    counts = {n: (reg.hit_count(n), reg.fire_count(n)) for n in names}
    return outcomes, log, counts


@pytest.mark.parametrize("seed", [1, 24, 303])
@pytest.mark.parametrize("spec", FAILPOINT_SPECS[:2])
def test_seeded_fire_sequence_gives_the_same_hit_log(spec, seed):
    jax_run = _fire_script("ray_tpu", spec, seed)
    port_run = _fire_script("ray_tpu_torch", spec, seed)
    assert jax_run == port_run
    assert jax_run[1]           # something fired


def _link_script(pkg, spec, seed):
    nc = _mod(pkg, "netchaos")
    reg = nc.Registry(seed)
    for pol in nc.parse_spec(spec):
        reg.install(pol)
    verdicts = []
    t0 = 1000.0
    for pol in reg._policies:
        for i in range(80):
            # explicit clock: windows and flaps replay exactly
            effect, delay_s, healed = pol.decide(64 + 16 * i,
                                                 now=t0 + i * 0.005)
            verdicts.append((pol.key, effect, round(delay_s, 12), healed))
    return verdicts, reg.describe()


@pytest.mark.parametrize("seed", [7, 24])
@pytest.mark.parametrize("spec", NETCHAOS_SPECS)
def test_link_policy_gives_the_same_verdicts_and_delays(spec, seed):
    jax_run = _link_script("ray_tpu", spec, seed)
    port_run = _link_script("ray_tpu_torch", spec, seed)
    assert jax_run == port_run
    effects = {v[1] for v in jax_run[0]} | {v[2] > 0 for v in jax_run[0]}
    assert effects - {None, False}      # the policy impaired something


@pytest.mark.parametrize("kw", [
    {},
    {"base_s": 0.01, "max_backoff_s": 0.25},
    {"base_s": 0.05, "max_backoff_s": 2.0, "multiplier": 3.0},
    {"base_s": 0.02, "max_backoff_s": 0.2, "jitter": False},
])
def test_retry_policy_gives_the_same_backoffs(kw):
    out = {}
    for pkg in PACKAGES:
        policy = _mod(pkg, "retry").RetryPolicy(**kw)
        rng = random.Random(24)
        out[pkg] = [policy.backoff_s(a, rng) for a in range(80)]
    assert out["ray_tpu"] == out["ray_tpu_torch"]


def test_task_retry_schedules_agree():
    jax_p = _mod("ray_tpu", "retry").TASK_RETRY
    port_p = _mod("ray_tpu_torch", "retry").TASK_RETRY
    assert (jax_p.base_s, jax_p.max_backoff_s, jax_p.multiplier) == (
        port_p.base_s, port_p.max_backoff_s, port_p.multiplier)


@pytest.mark.parametrize("watermarks", ["0.70,0.85", "0.5,0.6", "bad"])
def test_compute_level_agrees_over_a_grid(watermarks):
    grid = [i / 20 for i in range(22)]
    out = {}
    for pkg in PACKAGES:
        pr = _mod(pkg, "pressure")
        soft, hard = pr.parse_watermarks(watermarks)
        out[pkg] = [pr.compute_level(h, a, s, soft, hard, 0.95)
                    for h in grid for a in grid for s in (0.0, 0.5, 1.0)]
    assert out["ray_tpu"] == out["ray_tpu_torch"]
    assert set(out["ray_tpu"]) == {"ok", "soft", "hard"}
