"""User-extensible sink for prediction outputs, the port's copy of
elasticdl_tpu/worker/prediction_outputs_processor.py: a zoo module
exports a ``PredictionOutputsProcessor`` (a subclass of
BasePredictionOutputsProcessor, an instance, or a bare callable) whose
``process(predictions, worker_id)`` receives the prediction outputs."""

from abc import ABC, abstractmethod


class BasePredictionOutputsProcessor(ABC):
    @abstractmethod
    def process(self, predictions, worker_id):
        """Process prediction outputs (an ndarray, or a dict of ndarrays
        for multi-output models) of the worker `worker_id`."""


def resolve_processor(processor):
    """The spec's processor (class, instance or bare callable) as one
    ``fn(predictions, worker_id)``. A class is instantiated once, so a
    stateful processor keeps its state across batches."""
    if processor is None:
        return None
    if isinstance(processor, type) and issubclass(
            processor, BasePredictionOutputsProcessor):
        processor = processor()
    if isinstance(processor, BasePredictionOutputsProcessor):
        return processor.process
    return lambda predictions, worker_id: processor(predictions)


def invoke_processor(processor, predictions, worker_id=0):
    """One-shot resolve_processor and call."""
    fn = resolve_processor(processor)
    if fn is not None:
        fn(predictions, worker_id)
