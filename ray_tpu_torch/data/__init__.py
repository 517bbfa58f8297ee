"""ray_tpu_torch.data — streaming distributed datasets (counterpart of
``ray_tpu.data``, with its names).

Reference: Ray Data (`python/ray/data`, SURVEY.md §2.2, §3.6): lazy
Dataset → logical plan → rule optimizer → physical operators →
streaming executor with backpressure; blocks in the object store. The
port's blocks are tables of numpy columns (``block.py``), since the card's
machine has no pyarrow; the file formats that need pyarrow, pandas or PIL
import them when called. ``DataIterator.to_jax`` keeps JAX's name and feeds
the card: batches staged in pinned host memory and copied on a side CUDA
stream while the previous batch computes (BASELINE.md config 4). Importing
this package imports no ``torch``.
"""

from ray_tpu_torch.data.aggregate import Count, Max, Mean, Min, Std, Sum
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (from_arrow, from_items, from_numpy,
                                         from_pandas, from_torch, range,
                                         read_avro, read_binary_files,
                                         read_csv, read_delta, read_images,
                                         read_json, read_numpy, read_orc,
                                         read_parquet, read_sql, read_text,
                                         read_tfrecords, read_webdataset)

__all__ = [
    "Dataset", "GroupedData", "DataIterator",
    "range", "from_items", "from_numpy", "from_pandas", "from_arrow", "from_torch",
    "read_parquet", "read_csv", "read_json", "read_text",
    "read_binary_files",
    "read_images",
    "read_numpy",
    "read_sql",
    "read_avro",
    "read_delta",
    "read_orc",
    "read_tfrecords",
    "read_webdataset",
    "Count", "Sum", "Min", "Max", "Mean", "Std",
]
