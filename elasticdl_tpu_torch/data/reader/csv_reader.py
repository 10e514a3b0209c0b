"""CSV reader: the port's copy of elasticdl_tpu/data/reader/csv_reader.py.

Every `.csv` file of `data_dir` (sorted by name) is one shard of (0,
its row count less the header), so CSV sources are cut into record
ranges as TRec files are; a record is one row, a list of strings.
"""

import csv
import os

from elasticdl_tpu_torch.data.reader.data_reader import (
    AbstractDataReader,
    Metadata,
    check_required_kwargs,
)


class CSVDataReader(AbstractDataReader):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        check_required_kwargs(["data_dir"], kwargs)
        self._kwargs = kwargs
        self._sep = kwargs.get("sep", ",")

    def _paths(self):
        data_dir = self._kwargs["data_dir"]
        return [os.path.join(data_dir, f) for f in sorted(os.listdir(data_dir))
                if f.endswith(".csv")]

    def read_records(self, task):
        with open(task.shard_name, newline="") as f:
            reader = csv.reader(f, delimiter=self._sep)
            next(reader, None)  # the header
            for i, row in enumerate(reader):
                if i < task.start:
                    continue
                if i >= task.end:
                    break
                yield row

    def create_shards(self):
        shards = {}
        for path in self._paths():
            with open(path, newline="") as f:
                n = sum(1 for _ in f) - 1  # less the header
            shards[path] = (0, max(0, n))
        return shards

    @property
    def metadata(self):
        paths = self._paths()
        if not paths:
            return Metadata(column_names=None)
        with open(paths[0], newline="") as f:
            header = next(csv.reader(f, delimiter=self._sep), None)
        return Metadata(column_names=header)
