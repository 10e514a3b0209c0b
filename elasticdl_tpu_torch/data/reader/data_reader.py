"""The data-source interface: the port's copy of
elasticdl_tpu/data/reader/data_reader.py.

A reader exposes `read_records(task)` (a generator over the task's
record range of its shard) and `create_shards()` (the {shard_name:
(start, num_records)} map the dispatcher cuts into tasks). Tasks, not
ranks, are the unit of work, which is what lets the worker count
change.
"""

from abc import ABC, abstractmethod


class Metadata(object):
    """Dataset metadata handed to a zoo's dataset_fn: column names and
    dtypes for table-like sources (a CSV file's header), None for record
    files."""

    def __init__(self, column_names=None, column_dtypes=None):
        self.column_names = column_names
        self.column_dtypes = column_dtypes


class AbstractDataReader(ABC):
    def __init__(self, **kwargs):
        pass

    @abstractmethod
    def read_records(self, task):
        """Yield the raw records (bytes, or parsed rows) of `task`'s
        [start, end) range of its shard."""

    @abstractmethod
    def create_shards(self):
        """Return {shard_name: (start_index, num_records)}."""

    @property
    def metadata(self):
        return Metadata(column_names=None)


def check_required_kwargs(required_args, kwargs):
    missing = [k for k in required_args if k not in kwargs]
    if missing:
        raise ValueError(
            "The following required arguments are missing: %s"
            % ", ".join(missing)
        )
