"""Criteo Wide&Deep: the PyTorch twin of model_zoo/dac_ctr/wide_deep_model.py
(the reference's wide_deep_model.py): linear logits from the dim-1 group
tables and a Dense(1) over the standardized dense tensor; the deep
tower DNN[16, 4] over the dense tensor and the dim-8 tables' sums, then
Dense(1); the sum of [linear, dnn] is the logit."""

from elasticdl_tpu_torch.model_zoo.dac_ctr.utils import CTRModel


class WideDeepCTR(CTRModel):
    def logit_parts(self, dnn_input, deep_embeddings):
        return [self.Dense_1(self.DNN_0(dnn_input))]


def wide_deep_model(max_ids, device=None, generator=None):
    return WideDeepCTR(max_ids, device=device, generator=generator)
