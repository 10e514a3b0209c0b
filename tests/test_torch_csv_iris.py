"""The port's CSV reader, its reader factory and the iris model over CSV
rows against the JAX package's, on the CPU.

`gen_iris_csv` writes the JAX generator's files byte for byte; the CSV
reader's shards, rows and metadata equal the JAX reader's; the factory
picks it for a directory of .csv files and for reader_type="CSV" (ODPS
still raises). odps_iris_dnn_model loads from both zoos by its JAX
`--model_def` string; both packages train it from one JAX checkpoint
(the JAX Trainer's own initial state) over the same CSV files, through
the LocalExecutor and through an in-process Master and Worker, with
losses to 1e-5 relative (fp32, one Dense layer, SGD 0.1) and the same
tasks and evaluation accuracy.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax

from elasticdl_tpu.api.local_executor import LocalExecutor as JLocalExecutor
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.common.model_utils import get_model_spec as jget_spec
from elasticdl_tpu.data import recordio_gen as jrecordio_gen
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.data.reader import data_reader_factory as jfactory
from elasticdl_tpu.data.reader.csv_reader import CSVDataReader as JCSVReader
from elasticdl_tpu.master.master import Master as JMaster
from elasticdl_tpu.master.task_dispatcher import Task as JTask
from elasticdl_tpu.master.task_dispatcher import TaskType as JTaskType
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.model_utils import get_model_spec
from elasticdl_tpu_torch.convert import zoo_params_from_flax
from elasticdl_tpu_torch.data import recordio_gen
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.reader import data_reader_factory as factory
from elasticdl_tpu_torch.data.reader import recordio_reader
from elasticdl_tpu_torch.data.reader.csv_reader import CSVDataReader
from elasticdl_tpu_torch.data.reader.data_reader import (
    AbstractDataReader,
    Metadata,
    check_required_kwargs,
)
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.master.task_dispatcher import Task, TaskType
from elasticdl_tpu_torch.worker.worker import Worker
from test_torch_vision_zoo import JAX_ZOO, PORT_ZOO

torch.set_num_threads(2)

IRIS_DEF = "odps_iris_dnn_model.odps_iris_dnn_model.custom_model"
LOSS_RTOL = 1e-5
MINIBATCH = 16
PER_TASK = 32


def specs():
    return jget_spec(JAX_ZOO, IRIS_DEF), get_model_spec(PORT_ZOO, IRIS_DEF)


@pytest.fixture(scope="module")
def iris(tmp_path_factory):
    """Two CSV files of 48 rows (the last task of each file ends in a
    partial batch), a validation file, and a JAX checkpoint of the JAX
    Trainer's initial state that both packages start from."""
    root = tmp_path_factory.mktemp("iris")
    train = str(root / "train")
    valid = str(root / "valid")
    jrecordio_gen.gen_iris_csv(train, num_files=2, rows_per_file=48)
    jrecordio_gen.gen_iris_csv(valid, num_files=1, rows_per_file=20, seed=5)
    jspec, _spec = specs()
    trainer = JTrainer(jspec, mesh=mesh_lib.build_mesh(
        {"dp": 1}, devices=jax.devices()[:1]))
    state = trainer.init_state(({"input": np.zeros((2, 4), np.float32)},
                                np.zeros((2,), np.int32)))
    init = str(root / "init")
    JSaver(init).save(state, 0)
    return {"train": train, "valid": valid, "init": init,
            "params": jax.tree.map(np.asarray, state.params)}


# ---------------------------------------------------------------- data


def test_gen_iris_csv_writes_the_jax_files(tmp_path):
    paths = recordio_gen.gen_iris_csv(str(tmp_path / "p"), num_files=2,
                                      rows_per_file=5, seed=3)
    jpaths = jrecordio_gen.gen_iris_csv(str(tmp_path / "j"), num_files=2,
                                        rows_per_file=5, seed=3)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in jpaths] == ["iris-0000.csv",
                                                 "iris-0001.csv"]
    for p, j in zip(paths, jpaths):
        with open(p, "rb") as a, open(j, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("sep", [",", ";"])
def test_csv_reader_matches_jax(sep, tmp_path):
    data = tmp_path / "d"
    data.mkdir()
    for name, n in (("b.csv", 7), ("a.csv", 12)):
        rows = [["x", "y", "label"]] + [[str(i), str(i * 2), str(i % 3)]
                                        for i in range(n)]
        (data / name).write_text("".join(sep.join(r) + "\n" for r in rows))
    (data / "notes.txt").write_text("not a csv\n")
    ours = CSVDataReader(data_dir=str(data), sep=sep)
    ref = JCSVReader(data_dir=str(data), sep=sep)
    shards = ours.create_shards()
    assert shards == ref.create_shards()
    assert list(shards) == [str(data / "a.csv"), str(data / "b.csv")]
    assert shards[str(data / "a.csv")] == (0, 12)
    for shard, (start, n) in shards.items():
        for lo, hi in ((start, n), (3, 6), (5, 99)):
            got = list(ours.read_records(Task(shard, lo, hi,
                                              TaskType.TRAINING)))
            assert got == list(ref.read_records(JTask(
                shard, lo, hi, JTaskType.TRAINING)))
        assert len(list(ours.read_records(Task(
            shard, 0, n, TaskType.TRAINING)))) == n
    assert ours.metadata.column_names == ref.metadata.column_names == [
        "x", "y", "label"]
    empty = tmp_path / "empty"
    empty.mkdir()
    reader = CSVDataReader(data_dir=str(empty))
    assert reader.create_shards() == {}
    assert reader.metadata.column_names is None
    with pytest.raises(ValueError, match="data_dir"):
        CSVDataReader(sep=sep)


def test_factory_picks_the_readers_as_jax(iris, tmp_path):
    mixed = tmp_path / "mixed"
    recordio_gen.gen_mnist_like(str(mixed), num_files=1, records_per_file=2)
    (mixed / "x.csv").write_text("a\n1\n")
    for origin, kw in ((iris["train"], {}), (iris["train"], {
            "reader_type": "CSV"}), (str(mixed), {}), (iris["train"], {
                "reader_type": "RecordIO"})):
        ours = factory.create_data_reader(origin, PER_TASK, **kw)
        ref = jfactory.create_data_reader(origin, PER_TASK, **kw)
        assert type(ours).__name__ == type(ref).__name__
        assert isinstance(ours, AbstractDataReader)
    reader = factory.build_data_reader(iris["train"], PER_TASK,
                                       "reader_type='CSV'; sep=','")
    assert isinstance(reader, CSVDataReader)
    assert sorted(reader.create_shards().values()) == [(0, 48), (0, 48)]
    with pytest.raises(NotImplementedError):
        factory.create_data_reader("table", PER_TASK, reader_type="ODPS")


def test_reader_interface_keeps_the_jax_names():
    assert recordio_reader.Metadata is Metadata
    assert Metadata().column_names is None
    with pytest.raises(TypeError):
        AbstractDataReader()
    check_required_kwargs(["a"], {"a": 1})
    with pytest.raises(ValueError, match="b, c"):
        check_required_kwargs(["a", "b", "c"], {"a": 1})


@pytest.mark.parametrize("mode", [Mode.TRAINING, Mode.EVALUATION,
                                  Mode.PREDICTION])
def test_iris_dataset_fn_matches_jax(mode, iris):
    jspec, spec = specs()
    reader = CSVDataReader(data_dir=iris["train"])
    shard, (start, n) = sorted(reader.create_shards().items())[0]
    rows = list(reader.read_records(Task(shard, start, n,
                                         TaskType.TRAINING)))
    got = list(spec.dataset_fn(Dataset.from_list(rows), mode,
                               reader.metadata))
    want = list(jspec.dataset_fn(JDataset.from_list(rows), mode,
                                 reader.metadata))
    assert len(got) == len(want) == 48
    for g, w in zip(got, want):
        if mode != Mode.PREDICTION:
            assert g[1].dtype == w[1].dtype == np.int32
            assert g[1].shape == w[1].shape == () and g[1] == w[1]
            g, w = g[0], w[0]
        assert g["input"].dtype == w["input"].dtype == np.float32
        np.testing.assert_array_equal(g["input"], w["input"])


# --------------------------------------------------------------- model


def test_iris_forward_matches_flax(iris):
    jspec, spec = specs()
    model = spec.create_model("", device="cpu")
    model.load_state_dict(zoo_params_from_flax(iris["params"]), strict=True)
    assert sorted(model.state_dict()) == ["output.bias", "output.weight"]
    x = np.random.RandomState(3).rand(5, 4).astype(np.float32) * 7
    ref = jspec.model_fn().apply({"params": iris["params"]}, {"input": x})
    with torch.no_grad():
        out = model({"input": torch.as_tensor(x)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _executor(pkg, iris, **kwargs):
    jspec, spec = specs()
    common = dict(training_data=iris["train"], validation_data=iris["valid"],
                  minibatch_size=MINIBATCH, records_per_task=PER_TASK,
                  num_epochs=2, checkpoint_dir_for_init=iris["init"],
                  **kwargs)
    if pkg == "jax":
        return JLocalExecutor(jspec, **common)
    return LocalExecutor(spec, device="cpu", **common)


def test_iris_local_executor_matches_jax(iris):
    """Two epochs over the CSV files from one JAX checkpoint: the same
    losses, step for step, and the same evaluation accuracy."""
    runs = {}
    for pkg in ("jax", "port"):
        random.seed(0)  # the task shuffle
        executor = _executor(pkg, iris)
        state, metrics = executor.train()
        runs[pkg] = (list(executor.losses), metrics, int(state.step))
    (jl, jm, js), (pl, pm, ps) = runs["jax"], runs["port"]
    # 2 files x 2 epochs: tasks of 32 and 16 rows, 3 batches a file
    assert ps == js == 12 and len(pl) == len(jl) == 12
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL, atol=0)
    assert sorted(pm) == sorted(jm) == ["accuracy"]
    np.testing.assert_allclose(pm["accuracy"], jm["accuracy"], rtol=1e-6)


def test_iris_job_through_the_master_matches_jax(iris):
    """The elastic job in process: a Master that builds its shards with
    the reader factory from the CSV directory, and a Worker that reads
    its tasks' rows through `build_data_reader`, in each package; the
    same tasks and the same losses."""
    runs = {}
    for pkg in ("jax", "port"):
        random.seed(0)  # the task shuffle
        jspec, spec = specs()
        master = (JMaster if pkg == "jax" else Master)(
            jspec if pkg == "jax" else spec, training_data=iris["train"],
            minibatch_size=MINIBATCH, records_per_task=PER_TASK)
        tasks = sorted((os.path.basename(t.shard_name), t.start, t.end)
                       for t in master.task_d._todo)
        common = dict(master_servicer=master.servicer,
                      job_type="training_only", minibatch_size=MINIBATCH,
                      training_data=iris["train"], wait_sleep_secs=0.01,
                      checkpoint_dir_for_init=iris["init"])
        if pkg == "jax":
            worker = JWorker(0, jspec, mesh=mesh_lib.build_mesh(
                {"dp": 1}, devices=jax.devices()[:1]), **common)
        else:
            worker = Worker(0, spec, device="cpu", **common)
        worker.run()
        assert master.task_d.finished() and worker.job_complete
        runs[pkg] = (tasks, list(worker.losses))
    assert runs["port"][0] == runs["jax"][0] == [
        ("iris-0000.csv", 0, 32), ("iris-0000.csv", 32, 48),
        ("iris-0001.csv", 0, 32), ("iris-0001.csv", 32, 48)]
    assert len(runs["port"][1]) == 6
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1],
                               rtol=LOSS_RTOL, atol=0)
