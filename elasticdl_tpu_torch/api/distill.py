"""Draft-model distillation for speculative decoding: the port of
elasticdl_tpu/api/distill.py.

* `warm_start_draft` copies every top-level parameter subtree of the
  target (wte, wpe, ln_f, head, block_0 .. block_{N-1}, by their flax
  names) whose names and shapes match the draft's into the draft: a
  2-layer draft of an 8-layer target starts as the target without its
  upper blocks.
* `distill_draft` minimizes mean KL(softmax(t / T) || softmax(d / T))
  over the target's next-token distributions on the given token
  batches, with Adam (training/optimizers.py's, as optax.adam), the
  target frozen. The draft's forward runs the flash forward and its
  backward the flash backward; the target runs under no_grad.
"""

import logging
from collections.abc import Mapping

import torch

from elasticdl_tpu_torch.api.quantization import (
    dequantize_params,
    is_quantized,
)
from elasticdl_tpu_torch.convert import flax_param_path, params_from_flax
from elasticdl_tpu_torch.training.optimizers import adam

logger = logging.getLogger(__name__)


def _target_state(target):
    """{torch key: tensor} of a port model, or of a flax-named tree
    (int8 leaves dequantized first)."""
    if isinstance(target, Mapping):
        if is_quantized(target):
            target = dequantize_params(target)
        return params_from_flax(target)
    return target.state_dict()


def _subtrees(state):
    """{top-level flax name: {torch key: tensor}}."""
    out = {}
    for key, t in state.items():
        out.setdefault(flax_param_path(key).split("/")[0], {})[key] = t
    return out


@torch.no_grad()
def warm_start_draft(target, draft):
    """Copy each top-level subtree whose names and shapes match from
    `target` (a port model, or a flax-named tree such as an export's,
    int8 leaves dequantized) into the port model `draft`, in place, each
    value cast to the draft parameter's dtype. Returns the names
    copied."""
    src = _subtrees(_target_state(target))
    dst = _subtrees(dict(draft.named_parameters()))
    copied = []
    for name, params in sorted(dst.items()):
        have = src.get(name)
        if have is None or sorted(have) != sorted(params) or any(
                tuple(have[k].shape) != tuple(p.shape)
                for k, p in params.items()):
            continue
        for key, p in params.items():
            p.copy_(have[key].to(p.device, p.dtype))
        copied.append(name)
    logger.info("warm_start_draft copied subtrees: %s", copied)
    return copied


def distill_draft(target, draft, batches, lr=1e-3, temperature=1.0):
    """Soft-label distillation of the port model `draft` against the
    frozen port model `target`. `batches`: int token arrays [b, l] (l at
    most both models' seq_len). Each batch is one Adam step on mean
    KL(softmax(t / T) || softmax(d / T)) over every position. Updates
    the draft's parameters in place; returns the per-step losses."""
    inv_t = 1.0 / float(temperature)
    params = [p for p in draft.parameters()]
    for p in params:
        p.requires_grad_(True)
    opt = adam(lr)(params)
    losses = []
    for tokens in batches:
        features = {"tokens": torch.as_tensor(tokens).long()}
        with torch.no_grad():
            t_logits = target(features, training=False)
            t_lp = torch.log_softmax(t_logits.float() * inv_t, dim=-1)
        opt.zero_grad(set_to_none=True)
        d_logits = draft(features, training=False)
        d_lp = torch.log_softmax(d_logits.float() * inv_t, dim=-1)
        loss = (t_lp.exp() * (t_lp - d_lp)).sum(-1).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    if losses:
        logger.info("distill_draft: %d steps, KL %.4f -> %.4f",
                    len(losses), losses[0], losses[-1])
    return losses
