"""Synthetic record files (TRec) made from a seed: the port's copy of the
part of elasticdl_tpu/data/recordio_gen.py its tests and chip_smoke.py
use. The same seed gives the same records, byte for byte, as the JAX
package's generator."""

import os

import numpy as np

from elasticdl_tpu_torch.data.example_codec import encode_example
from elasticdl_tpu_torch.data.record_format import RecordWriter


def _generate(data_dir, prefix, make_example, num_files, records_per_file,
              seed):
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i in range(num_files):
        path = os.path.join(data_dir, "%s-%04d.trec" % (prefix, i))
        with RecordWriter(path) as w:
            for _ in range(records_per_file):
                w.write(encode_example(make_example(rng)))
        paths.append(path)
    return paths


def gen_frappe_like(data_dir, num_files=2, records_per_file=128,
                    feature_dim=10, input_dim=5383, seed=0):
    """Sparse-id recommendation records (the frappe schema: a fixed-length
    id list `feature` in [0, input_dim) and a binary `label`), what the
    DeepFM models read."""
    def example(rng):
        return {
            "feature": rng.randint(input_dim, size=feature_dim).astype(
                np.int64),
            "label": np.array([rng.randint(2)], dtype=np.int32),
        }

    return _generate(data_dir, "frappe", example, num_files,
                     records_per_file, seed)
