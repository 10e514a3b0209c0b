"""Criteo DeepFM: the PyTorch twin of model_zoo/dac_ctr/deepfm_model.py
(the reference's deepfm_model.py): the linear logits, a DNN[16, 4] logit
and the FM pairwise term over the stacked dim-8 group sums; their sum is
the logit."""

import torch

from elasticdl_tpu_torch.model_zoo.dac_ctr.utils import FM, CTRModel


class DeepFMCTR(CTRModel):
    def __init__(self, max_ids, device=None, generator=None):
        super().__init__(max_ids, device=device, generator=generator)
        self.fm = FM()

    def logit_parts(self, dnn_input, deep_embeddings):
        parts = [self.Dense_1(self.DNN_0(dnn_input))]
        if len(deep_embeddings) > 1:
            parts.append(self.fm(torch.stack(deep_embeddings, dim=1)))
        return parts


def deepfm_model(max_ids, device=None, generator=None):
    return DeepFMCTR(max_ids, device=device, generator=generator)
