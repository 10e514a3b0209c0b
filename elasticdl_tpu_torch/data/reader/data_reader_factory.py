"""Reader factory: the port's copy of
elasticdl_tpu/data/reader/data_reader_factory.py for TRec and CSV data.

`create_data_reader` returns a CSVDataReader for a directory of .csv
files (or reader_type="CSV") and a RecordIODataReader for a TRec
directory (reader_type="RecordIO", or a directory that is not all .csv
files). ODPS tables (reader_type "ODPS", or MaxCompute credentials in
the environment with a table name for an origin) raise: that reader is
not ported.
"""

import os

from elasticdl_tpu_torch.common.constants import ReaderType
from elasticdl_tpu_torch.common.model_utils import get_dict_from_params_str
from elasticdl_tpu_torch.data.reader.csv_reader import CSVDataReader
from elasticdl_tpu_torch.data.reader.recordio_reader import (
    RecordIODataReader,
)


def _odps_env():
    """True when MaxCompute credentials are in the environment (the JAX
    factory then reads a table-name origin from ODPS)."""
    env = os.environ
    return bool((env.get("MAXCOMPUTE_AK") or env.get("ODPS_ACCESS_ID"))
                and (env.get("MAXCOMPUTE_SK") or env.get("ODPS_ACCESS_KEY"))
                and (env.get("MAXCOMPUTE_PROJECT")
                     or env.get("ODPS_PROJECT_NAME")))


def _not_ported(kind, data_origin):
    raise NotImplementedError(
        "the %s data reader is not ported (origin %r); the port reads TRec "
        "record files and CSV files" % (kind, data_origin))


def create_data_reader(data_origin, records_per_task=None, **kwargs):
    reader_type = kwargs.pop("reader_type", None)
    kwargs.setdefault("data_dir", data_origin)
    if records_per_task is not None:
        kwargs.setdefault("records_per_task", records_per_task)
    if reader_type is None:
        if (_odps_env() and data_origin and os.sep not in data_origin
                and not os.path.exists(data_origin)):
            _not_ported("ODPS", data_origin)
        if data_origin and os.path.isdir(data_origin):
            names = os.listdir(data_origin)
            if names and all(n.endswith(".csv") for n in names):
                return CSVDataReader(**kwargs)
        return RecordIODataReader(**kwargs)
    if reader_type == ReaderType.CSV:
        return CSVDataReader(**kwargs)
    if reader_type == ReaderType.RECORDIO:
        return RecordIODataReader(**kwargs)
    if reader_type == ReaderType.ODPS:
        _not_ported(reader_type, data_origin)
    raise ValueError("Unknown reader_type %s" % reader_type)


def build_data_reader(data_origin, records_per_task=None,
                      data_reader_params=None, custom_data_reader=None):
    """The one reader-construction contract of the worker's
    TaskDataService and the master's submission-time check: a
    spec-declared custom_data_reader wins, else the factory; params may
    be the 'k=v; k=v' string or a dict."""
    if isinstance(data_reader_params, str):
        data_reader_params = get_dict_from_params_str(data_reader_params)
    create_fn = custom_data_reader or create_data_reader
    return create_fn(
        data_origin, records_per_task, **(data_reader_params or {})
    )
