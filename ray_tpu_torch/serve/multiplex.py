"""Model multiplexing (counterpart of ``ray_tpu/serve/multiplex.py``;
reference: `python/ray/serve/multiplex.py` —
``@serve.multiplexed`` caches up to N models per replica, LRU-evicted;
requests carry a model id that routes to a replica holding it)."""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Any, Callable

_current_model_id = threading.local()


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the current request."""
    return getattr(_current_model_id, "value", "")


def _set_model_id(model_id: str):
    _current_model_id.value = model_id


class _ModelCache:
    def __init__(self, loader: Callable[[Any, str], Any],
                 max_num_models: int):
        self.loader = loader
        self.max_num_models = max_num_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, owner, model_id: str) -> Any:
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        model = (self.loader(owner, model_id) if owner is not None
                 else self.loader(model_id))
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self.max_num_models:
                old_id, old = self._models.popitem(last=False)
                unload = getattr(old, "__del__", None)
        return model

    def ids(self):
        with self._lock:
            return list(self._models)


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator over an async-or-sync model loader method/function:

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str): ...

    The wrapped loader becomes an LRU-cached lookup.
    """
    def wrap(loader):
        cache = _ModelCache(loader, max_num_models_per_replica)

        @functools.wraps(loader)
        def wrapper(*args):
            if len(args) == 2:
                owner, model_id = args
            else:
                owner, (model_id,) = None, args
            return cache.get(owner, model_id)

        wrapper._model_cache = cache
        return wrapper
    return wrap
