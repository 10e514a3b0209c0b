"""Criteo xDeepFM: the PyTorch twin of model_zoo/dac_ctr/xdeepfm_model.py
(the reference's xdeepfm_model.py): the linear logits, a DNN[16, 4]
logit and a CIN (128, 128) over the stacked dim-8 group sums with a
Dense(1) head (`Dense_2`); their sum is the logit. The CIN is the JAX
package's plain (non-split-half) variant."""

import torch

from elasticdl_tpu_torch.model_zoo.dac_ctr.utils import CIN, CTRModel
from elasticdl_tpu_torch.model_zoo.flax_layers import Dense

CIN_SIZES = (128, 128)


class XDeepFMCTR(CTRModel):
    def __init__(self, max_ids, device=None, generator=None):
        super().__init__(max_ids, device=device, generator=generator)
        if self.n_fields > 1:
            self.CIN_0 = CIN(self.n_fields, CIN_SIZES, device, generator)
            self.Dense_2 = Dense(sum(CIN_SIZES), 1, device=device,
                                 generator=generator)

    def logit_parts(self, dnn_input, deep_embeddings):
        parts = [self.Dense_1(self.DNN_0(dnn_input))]
        if len(deep_embeddings) > 1:
            stacked = torch.stack(deep_embeddings, dim=1)  # [B, F, D]
            parts.append(self.Dense_2(self.CIN_0(stacked)))
        return parts


def xdeepfm_model(max_ids, device=None, generator=None):
    return XDeepFMCTR(max_ids, device=device, generator=generator)
