"""Synthetic record files (TRec) made from a seed: the port's copy of the
part of elasticdl_tpu/data/recordio_gen.py its tests and chip_smoke.py
use (frappe for DeepFM; census, heart and Criteo for the tabular and CTR
zoo; MNIST, CIFAR-10 and ImageNet shapes for the vision zoo; token
sequences for transformer_lm and bert, variable-length documents for the
packed family, iris CSV rows). The same seed gives the same records (the
same CSV text), byte for byte, as the JAX package's generator."""

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


def gen_mnist_like(data_dir, num_files=2, records_per_file=128, seed=0):
    """28x28 float images in [0,1) + int32 labels in [0,10)."""
    def example(rng):
        return {
            "image": rng.rand(28, 28).astype(np.float32),
            "label": np.array([rng.randint(10)], dtype=np.int32),
        }

    return _generate(data_dir, "mnist", example, num_files,
                     records_per_file, seed)


def gen_cifar10_like(data_dir, num_files=2, records_per_file=128, seed=0):
    """32x32x3 float images in [0,1) + int32 labels in [0,10)."""
    def example(rng):
        return {
            "image": rng.rand(32, 32, 3).astype(np.float32),
            "label": np.array([rng.randint(10)], dtype=np.int32),
        }

    return _generate(data_dir, "cifar10", example, num_files,
                     records_per_file, seed)


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


def gen_census_like(data_dir, num_files=2, records_per_file=128, seed=0):
    """Tabular wide&deep records: a few dense floats + categorical ids."""
    def example(rng):
        return {
            "dense": rng.rand(5).astype(np.float32),
            "category": rng.randint(1000, size=8).astype(np.int64),
            "label": np.array([rng.randint(2)], dtype=np.int32),
        }

    return _generate(data_dir, "census", example, num_files,
                     records_per_file, seed)


CENSUS_CATEGORICAL_VOCAB = {
    "workclass": [b"Private", b"Self-emp-not-inc", b"Self-emp-inc",
                  b"Federal-gov", b"Local-gov", b"State-gov", b"Without-pay",
                  b"Never-worked"],
    "education": [b"Bachelors", b"HS-grad", b"11th", b"Masters", b"9th",
                  b"Some-college", b"Assoc-acdm", b"Assoc-voc", b"Doctorate"],
    "marital-status": [b"Married-civ-spouse", b"Divorced", b"Never-married",
                       b"Separated", b"Widowed", b"Married-spouse-absent",
                       b"Married-AF-spouse"],
    "occupation": [b"Tech-support", b"Craft-repair", b"Other-service",
                   b"Sales", b"Exec-managerial", b"Prof-specialty"],
    "relationship": [b"Wife", b"Own-child", b"Husband", b"Not-in-family",
                     b"Other-relative", b"Unmarried"],
    "race": [b"White", b"Asian-Pac-Islander", b"Amer-Indian-Eskimo",
             b"Other", b"Black"],
    "sex": [b"Female", b"Male"],
    "native-country": [b"United-States", b"Cambodia", b"England",
                       b"Puerto-Rico", b"Canada", b"Germany", b"India"],
}


def gen_census_raw(data_dir, num_files=2, records_per_file=128, seed=0):
    """Raw census-income schema (reference data/recordio_gen/census schema +
    tests/test_utils.py census fixtures): 8 string categoricals, 4 numerics,
    binary label."""
    def example(rng):
        ex = {}
        for name, vocab in CENSUS_CATEGORICAL_VOCAB.items():
            ex[name] = np.array(vocab[rng.randint(len(vocab))], dtype="S32")
        ex["age"] = np.array(rng.randint(17, 90), dtype=np.float32)
        ex["capital-gain"] = np.array(rng.randint(0, 9000),
                                      dtype=np.float32)
        ex["capital-loss"] = np.array(rng.randint(0, 4500),
                                      dtype=np.float32)
        ex["hours-per-week"] = np.array(rng.randint(1, 80),
                                        dtype=np.float32)
        ex["label"] = np.array(rng.randint(2), dtype=np.int64)
        return ex

    return _generate(data_dir, "census-raw", example, num_files,
                     records_per_file, seed)


def gen_heart_like(data_dir, num_files=2, records_per_file=128, seed=0):
    """Heart-disease schema (reference model_zoo/heart_functional_api
    dataset_fn feature_description)."""
    def example(rng):
        return {
            "age": np.array(rng.randint(18, 90), dtype=np.int64),
            "trestbps": np.array(rng.randint(90, 200), dtype=np.int64),
            "chol": np.array(rng.randint(120, 560), dtype=np.int64),
            "thalach": np.array(rng.randint(70, 210), dtype=np.int64),
            "oldpeak": np.array(rng.rand() * 6.0, dtype=np.float32),
            "slope": np.array(rng.randint(0, 3), dtype=np.int64),
            "ca": np.array(rng.randint(0, 4), dtype=np.int64),
            "thal": np.array(
                [b"fixed", b"normal", b"reversible"][rng.randint(3)],
                dtype="S16",
            ),
            "target": np.array(rng.randint(2), dtype=np.int64),
        }

    return _generate(data_dir, "heart", example, num_files,
                     records_per_file, seed)


def gen_imagenet_like(data_dir, num_files=1, records_per_file=16,
                      image_size=224, num_classes=1000, seed=0):
    """ImageNet-shaped records: HxWx3 uint8-valued floats (a 224 x 224
    image is 602 KB) + an int32 label."""
    def example(rng):
        return {
            "image": (rng.rand(image_size, image_size, 3) * 255).astype(
                np.float32
            ),
            "label": np.array([rng.randint(num_classes)], dtype=np.int32),
        }

    return _generate(data_dir, "imagenet", example, num_files,
                     records_per_file, seed)


def gen_criteo_like(data_dir, num_files=2, records_per_file=128, seed=0):
    """Criteo/DAC CTR schema (reference model_zoo/dac_ctr/feature_config:
    numeric I1..I13, categorical C1..C26 as strings, binary label)."""
    def example(rng):
        ex = {}
        for i in range(1, 14):
            ex["I%d" % i] = np.array(rng.rand() * 100, dtype=np.float32)
        for i in range(1, 27):
            ex["C%d" % i] = np.array(
                ("cat%d" % rng.randint(1000)).encode(), dtype="S16"
            )
        ex["label"] = np.array(rng.randint(2), dtype=np.int64)
        return ex

    return _generate(data_dir, "criteo", example, num_files,
                     records_per_file, seed)


def gen_iris_csv(data_dir, num_files=2, rows_per_file=64, seed=0):
    """Iris-style CSV files (a header, then 4 floats and a class label a
    row), for odps_iris_dnn_model through the CSV reader."""
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i in range(num_files):
        path = os.path.join(data_dir, "iris-%04d.csv" % i)
        with open(path, "w") as f:
            f.write("sepal_l,sepal_w,petal_l,petal_w,label\n")
            for _ in range(rows_per_file):
                vals = rng.rand(4) * 7.0
                f.write("%.3f,%.3f,%.3f,%.3f,%d\n"
                        % (*vals, rng.randint(3)))
        paths.append(path)
    return paths


def gen_tokens_like(data_dir, num_files=2, records_per_file=128, seed=0,
                    seq_len=33, vocab_size=64):
    """Token-sequence records (transformer_lm reads seq_len + 1 tokens a
    record, bert masks seq_len tokens), each carrying its vocab_size."""
    def example(rng):
        return {
            "tokens": rng.randint(
                0, vocab_size, size=(seq_len,)
            ).astype(np.int64),
            "vocab_size": np.array(vocab_size, np.int64),
        }

    return _generate(data_dir, "tokens", example, num_files,
                     records_per_file, seed)


def gen_docs_like(data_dir, num_files=2, records_per_file=128, seed=0,
                  vocab_size=64, min_len=4, max_len=48, cyclic=False):
    """Variable-length documents for the packed family
    (model_zoo/transformer_lm_packed): one document of min_len..max_len
    tokens a record; cyclic=True writes next = (tok + 1) % vocab
    cycles."""
    def example(rng):
        n = rng.randint(min_len, max_len + 1)
        if cyclic:
            tokens = (rng.randint(0, vocab_size)
                      + np.arange(n)) % vocab_size
        else:
            tokens = rng.randint(0, vocab_size, size=(n,))
        return {
            "tokens": tokens.astype(np.int64),
            "vocab_size": np.array(vocab_size, np.int64),
        }

    return _generate(data_dir, "docs", example, num_files,
                     records_per_file, seed)
