"""Packed transformer LM: variable-length documents packed into fixed
rows inside the worker's task stream; the port of
model_zoo/transformer_lm_packed.

The model is the port's transformer_lm; the difference is the data
path. Records are whole documents (one "tokens" array each, as the JAX
package's `recordio_gen.gen_docs_like` writes them), and dataset_fn
streams them through `data.packing.pack_dataset`: every row carries
`segment_ids`, so attention stays inside each document (the flash
kernels' segment masks), positions restart per document, and
cross-document next-token targets are label-masked. ROW_LEN is the
packing row length and the model's seq_len; dataset_fn cannot see
model_params, so custom_model refuses any other seq_len rather than
let the positional table and the packed width drift apart.
"""

import numpy as np

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.data.packing import pack_dataset
from elasticdl_tpu_torch.model_zoo.transformer_lm import (  # noqa: F401
    TransformerLM,
    flax_param_path,
    loss,
    loss_parts,
    optimizer,
    resolve_dtype,
)

ROW_LEN = 128


def custom_model(**kwargs):
    seq_len = kwargs.setdefault("seq_len", ROW_LEN)
    if seq_len != ROW_LEN:
        raise ValueError(
            "transformer_lm_packed packs %d-token rows; seq_len=%r would "
            "desynchronize the positional table from the packed width "
            "(edit ROW_LEN or copy the family for other lengths)"
            % (ROW_LEN, seq_len)
        )
    return TransformerLM(**resolve_dtype(kwargs, "transformer_lm_packed"))


def dataset_fn(dataset, mode, metadata):
    if mode == Mode.PREDICTION:
        raise ValueError(
            "the packed family trains and evaluates; use transformer_lm "
            "for prediction and decoding"
        )
    dataset = dataset.map(
        lambda record: decode_example(record)["tokens"].astype(np.int32)
    )
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=512, seed=0)
    return pack_dataset(dataset, ROW_LEN)


def eval_metrics_fn():
    def token_accuracy(labels, predictions):
        labels = np.asarray(labels)
        preds = np.argmax(np.asarray(predictions), axis=-1)
        valid = labels >= 0
        return (
            ((preds == labels) & valid).sum(axis=1)
            / np.maximum(valid.sum(axis=1), 1)
        ).astype(np.float32)

    return {"token_accuracy": token_accuracy}


def feature_shapes(seq_len=ROW_LEN):
    return {"tokens": (seq_len,), "segment_ids": (seq_len,)}
