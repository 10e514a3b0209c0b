"""The spec functions the port's vision zoo shares (mnist, cifar10,
resnet50_subclass, imagenet_resnet50): each JAX zoo module writes them
out, with the same records, labels and metric."""

import numpy as np
import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.example_codec import decode_example


def image_dataset_fn(divisor=None):
    """dataset_fn of the image records: `image` as float32 (divided by
    `divisor` as the JAX module divides it) and the int32 label;
    training shuffles with a 1024-record buffer."""
    def dataset_fn(dataset, mode, _metadata):
        def _parse(record):
            ex = decode_example(record)
            image = ex["image"].astype(np.float32)
            if divisor is not None:
                image = image / divisor
            features = {"image": image}
            if mode == Mode.PREDICTION:
                return features
            return features, ex["label"].astype(np.int32)[0]

        dataset = dataset.map(_parse)
        if mode == Mode.TRAINING:
            dataset = dataset.shuffle(buffer_size=1024, seed=0)
        return dataset

    return dataset_fn


def softmax_cross_entropy(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels: one value a row."""
    return F.cross_entropy(logits.to(torch.float32),
                           labels.reshape(-1).long(), reduction="none")


def mean_cross_entropy(labels, predictions):
    """mean(optax.softmax_cross_entropy_with_integer_labels)."""
    labels = torch.as_tensor(labels, device=predictions.device)
    return softmax_cross_entropy(predictions, labels).mean()


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: (
            np.argmax(predictions, axis=1) == np.asarray(labels).reshape(-1)
        ).astype(np.float32)
    }
