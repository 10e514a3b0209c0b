"""TRec reader: the port's copy of
elasticdl_tpu/data/reader/recordio_reader.py (pure-Python scanner only).

Shards are one file each, named by path, with (0, record_count);
`read_records` scans [task.start, task.end) of task.shard_name.
"""

import os

from elasticdl_tpu_torch.data import record_format


class Metadata(object):
    """Dataset metadata handed to a zoo's dataset_fn (column names and
    dtypes for table-like sources; None for record files)."""

    def __init__(self, column_names=None, column_dtypes=None):
        self.column_names = column_names
        self.column_dtypes = column_dtypes


class RecordIODataReader(object):
    def __init__(self, data_dir, **kwargs):
        """`kwargs` (records_per_task, ...) are the factory's; a TRec
        reader needs none of them."""
        del kwargs
        self._data_dir = data_dir

    @property
    def metadata(self):
        return Metadata()

    def read_records(self, task):
        return iter(record_format.Scanner(
            task.shard_name, task.start, task.end - task.start))

    def create_shards(self):
        if not self._data_dir:
            return {}
        shards = {}
        for fname in sorted(os.listdir(self._data_dir)):
            path = os.path.join(self._data_dir, fname)
            if os.path.isfile(path):
                shards[path] = (0, record_format.get_record_count(path))
        return shards
