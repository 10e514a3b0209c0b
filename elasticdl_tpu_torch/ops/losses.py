"""Loss math for large-vocabulary LM heads: the port of
elasticdl_tpu/ops/losses.py.

`chunked_softmax_xent` streams the head over sequence chunks and
recomputes each chunk's logits in the backward
(`torch.utils.checkpoint`), so the fp32 logits never exist for the whole
[b, s, vocab] at once. No kernel: plain PyTorch on every device.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def softmax_xent(logits, labels):
    """Per-token cross entropy of fp32 logits [..., vocab] against int
    labels [...] (optax's softmax_cross_entropy_with_integer_labels)."""
    vocab = logits.shape[-1]
    ce = F.cross_entropy(logits.reshape(-1, vocab).float(),
                         labels.reshape(-1).long(), reduction="none")
    return ce.reshape(labels.shape)


def chunked_softmax_xent(hidden, kernel, labels, num_chunks=8):
    """Per-token cross entropy of an LM head without full logits.

    hidden [b, s, d] (the matmul runs in hidden.dtype, the softmax in
    fp32); kernel [d, vocab] (cast to hidden.dtype at use); labels
    [b, s] int. Returns [b, s] fp32, equal to
    softmax_xent((hidden @ kernel).float(), labels). A sequence that does
    not divide into `num_chunks` is zero-padded up to the next multiple
    and the padded tail dropped, as in the JAX package."""
    b, s, _d = hidden.shape
    num_chunks = min(num_chunks, s)
    if num_chunks <= 1:
        return _direct_xent(hidden, kernel, labels)
    c = -(-s // num_chunks)
    pad = num_chunks * c - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    ce = [
        checkpoint(_direct_xent, hidden[:, i * c:(i + 1) * c], kernel,
                   labels[:, i * c:(i + 1) * c], use_reentrant=False)
        for i in range(num_chunks)
    ]
    return torch.cat(ce, dim=1)[:, :s]


def _direct_xent(hidden, kernel, labels):
    logits = torch.matmul(hidden, kernel.to(hidden.dtype)).float()
    return softmax_xent(logits, labels)
