"""ray_tpu_torch.tune — hyperparameter search / experiment execution
(counterpart of ``ray_tpu.tune``, with its names).

Reference: Ray Tune (`python/ray/tune`, SURVEY.md §2.2): Tuner → trials →
searchers + schedulers (ASHA/PBT) → trainable actors, with intermediate
reporting and checkpoint plumbing shared with Train. Tune itself places
nothing on a device: a trainable that trains on the card takes its device
from its config (``with_parameters(fn, device=...)``), and trials that share
one card run one at a time (``TuneConfig(max_concurrent_trials=1)``).
"""

from ray_tpu_torch.tune.schedulers import (AsyncHyperBandScheduler,
                                           FIFOScheduler,
                                           PopulationBasedTraining,
                                           TrialScheduler)
from ray_tpu_torch.tune.search import (BasicVariantGenerator, BOHBSearcher,
                                       HaltonSearcher, Searcher, TPESearcher)
from ray_tpu_torch.tune.search_space import (choice, grid_search, loguniform,
                                             randint, sample_from, uniform)
from ray_tpu_torch.tune.tuner import (ResultGrid, Trial, TuneConfig, Tuner,
                                      report, with_parameters)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "Trial", "report",
    "with_parameters",
    "uniform", "loguniform", "randint", "choice", "grid_search",
    "sample_from",
    "FIFOScheduler", "AsyncHyperBandScheduler", "PopulationBasedTraining",
    "TrialScheduler",
    "Searcher", "BasicVariantGenerator", "HaltonSearcher", "TPESearcher",
    "BOHBSearcher",
]
