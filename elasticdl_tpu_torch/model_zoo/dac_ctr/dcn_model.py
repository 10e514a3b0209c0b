"""Criteo DCN: the PyTorch twin of model_zoo/dac_ctr/dcn_model.py (the
reference's dcn_model.py): the linear logits; a DNN[16, 4] and a
2-layer CrossNet side by side over the deep input, a Dense(1) over
their concatenation; the sum with the linear logits is the logit."""

import torch

from elasticdl_tpu_torch.model_zoo.dac_ctr.utils import (
    DNN_UNITS,
    CTRModel,
    CrossNet,
)


class DCNCTR(CTRModel):
    def __init__(self, max_ids, device=None, generator=None):
        width = CTRModel.deep_width_of(max_ids)
        super().__init__(max_ids, head_width=DNN_UNITS[-1] + width,
                         device=device, generator=generator)
        self.CrossNet_0 = CrossNet(width, 2, device, generator)

    def logit_parts(self, dnn_input, deep_embeddings):
        both = torch.cat([self.DNN_0(dnn_input), self.CrossNet_0(dnn_input)],
                         dim=1)
        return [self.Dense_1(both)]


def dcn_model(max_ids, device=None, generator=None):
    return DCNCTR(max_ids, device=device, generator=generator)
