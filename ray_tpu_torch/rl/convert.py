"""The weights carried across from the JAX package's RL learners.

Every learner of ``ray_tpu/rl/`` keeps its params as a tree of dicts and
lists of ``{"w", "b"}`` layers: ``{"pi": [...], "vf": [...]}`` (PPO,
IMPALA, APPO), ``{"q": [...]}`` (DQN), SAC's ``pi``/``q1``/``q2`` and the
offline learners' bare lists. ``params_from_numpy`` turns such a tree,
handed over as numpy arrays, into f32 tensors on ``device`` with the same
nesting.

A learner's state is its trees under the JAX package's attribute names
(``STATE_KEYS``): ``"params"`` (the policy's params, or the offline
learners' ``params``), DQN's ``target_params``, SAC's ``q1``, ``q2``,
``q1_target``, ``q2_target`` and ``log_alpha``, and OfflineDQN's
``target``. The port's learners keep the same names, so ``learner_state``
reads either package's learner into numpy, and ``load_learner_state``
seeds a port learner from it: each tensor is overwritten in place (the
optimizer holds them), the optimizer goes back to its initial state
(optax and torch both start from zero moments) and the policy's numpy
act weights are refreshed.

JAX's trees are immutable, so it may share one between two owners
(``jnp.copy`` targets, the offline learners' aliased ``target``); torch
updates in place, so the port copies (``clone_tree``) wherever JAX shares,
and ``get_weights`` never hands out the live tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device

STATE_KEYS = ("params", "target_params", "q1", "q2", "q1_target",
              "q2_target", "log_alpha", "target")


def tree_map(fn: Callable, tree):
    """``fn`` at each leaf of a tree of dicts and lists (any array type)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device: DeviceLike = None):
    """A JAX RL param tree (numpy leaves) as f32 tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev), tree)


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``: on the CPU ``.numpy()`` alone would share
    storage with the tensor, which the next optimizer step overwrites."""
    return t.detach().to("cpu", copy=True).numpy()


def clone_tree(tree):
    """Detached copies of a tensor tree."""
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def assign_tree(dst, src) -> None:
    """Copy ``src`` (tensors or arrays, ``dst``'s nesting) into the tensors
    of ``dst`` in place."""
    if isinstance(dst, torch.Tensor):
        s = torch.as_tensor(src)
        if s.shape != dst.shape:
            raise ValueError(f"leaf of shape {tuple(s.shape)}, expected "
                             f"{tuple(dst.shape)}")
        dst.copy_(s)
    elif isinstance(dst, Mapping):
        if set(dst) != set(src):
            raise ValueError(f"keys {sorted(src)}, expected {sorted(dst)}")
        for k in dst:
            assign_tree(dst[k], src[k])
    else:
        if len(dst) != len(src):
            raise ValueError(f"{len(src)} entries, expected {len(dst)}")
        for d, s in zip(dst, src):
            assign_tree(d, s)


def _live_state(learner) -> Dict[str, Any]:
    policy = getattr(learner, "policy", None)
    out = {"params": policy.params if policy is not None
           else learner.params}
    out.update({k: getattr(learner, k) for k in STATE_KEYS[1:]
                if hasattr(learner, k)})
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return host_copy(x)
    return np.array(x, dtype=np.float32)


def learner_state(learner) -> Dict[str, Any]:
    """The state of a learner of either package as numpy trees."""
    return {k: tree_map(_to_numpy, v)
            for k, v in _live_state(learner).items()}


def load_learner_state(learner, state: Mapping[str, Any]) -> None:
    """Seed a port learner from ``state`` (``learner_state`` of a JAX or a
    port learner): every tree it holds, in place; then the optimizer's
    initial state and the numpy act weights."""
    live = _live_state(learner)
    unknown = sorted(set(state) - set(live))
    if unknown:
        raise KeyError(f"{type(learner).__name__} has no state {unknown}; "
                       f"it holds {sorted(live)}")
    for key, tree in state.items():
        assign_tree(live[key], tree)
    for name in ("optimizer", "opt"):
        opt = getattr(learner, name, None)
        if opt is not None:
            opt.state.clear()
    if hasattr(learner, "policy"):
        learner.policy._sync_np()
