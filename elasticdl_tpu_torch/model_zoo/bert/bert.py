"""BERT-class bidirectional encoder with a masked-LM objective: the
PyTorch twin of model_zoo/bert/bert.py, and the zoo spec around it.

The encoder is the port's transformer `Block` (model_zoo/transformer_lm)
with `causal=False`, under the flax names `layer_%d`: its attention runs
kernels A, C and D on the card without the causal mask, at head_dim 64
at BERT-base width. `wte` has vocab_size + 1 rows, the last the
reserved [MASK] id; `wpe` reads packed positions when `segment_ids`
are given (attention then stays inside each run); `attn_window` is a
two-sided window; LoRA adapters sit on the attention as in
transformer_lm. After `ln_f` the MLM head is `mlm_dense`, tanh GELU (as
flax's nn.gelu), `mlm_ln` and `mlm_head` (with a bias), the logits cast
to fp32. Matmul and embedding weights are used in the compute dtype
(`dtype`), norms in fp32, parameters kept in fp32, as in transformer_lm.

The model is bidirectional: `causal` is a class attribute, False, which
api/generation.py reads to refuse decoding it. Under an sp mesh (the
Trainer enters it) the forward takes this rank's sequence shard, as
transformer_lm's does: positions are global (sp_rank * l_local + i, or
the packed positions of the whole row, from the all-gathered segment
ids, sliced, since a document can cross a shard boundary), and the
Blocks' attention runs the non-causal ring. `loss_parts` is the loss's
partial form the Trainer reduces over the mesh. Under a tp mesh it
raises (ROADMAP Queue 1 item 7).

dataset_fn masks each record statically, seeded by the crc32 of its
tokens (15% targets: 80% [MASK], 10% a random token, 10% kept), with
numpy as the JAX module does, so masked tokens and labels equal the JAX
package's bit for bit. The loss averages cross entropy over the masked
positions only; the optimizer is adamw with weight decay 0.01.
"""

import zlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    Dense,
    Embed,
    LayerNorm,
    flax_generator,
    init_flax_,
)
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    _linear,
    check_attn_impl,
    encoder_blocks,
    refuse_mesh,
    resolve_dtype,
)
from elasticdl_tpu_torch.ops.attention import packed_positions
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.parallel.mesh import current_mesh
from elasticdl_tpu_torch.ops.losses import softmax_xent
from elasticdl_tpu_torch.training.optimizers import adamw

IGNORE_LABEL = -1
MASK_PROB = 0.15


class BertEncoder(nn.Module):
    # bidirectional: api/generation.py refuses to decode it. A class
    # attribute, not an argument, as in flax, so no model_params string
    # can set it out of step with the attention
    causal = False

    def __init__(self, vocab_size=256, seq_len=128, embed_dim=128,
                 num_heads=4, num_layers=2, dtype=None, attn_impl="auto",
                 tp_shard=True, lora_rank=0, lora_alpha=16.0, attn_window=0,
                 device="cuda", seed=0):
        super().__init__()
        check_attn_impl(attn_impl)
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.dtype = dtype or torch.float32
        self.attn_impl = attn_impl
        self.tp_shard = bool(tp_shard)
        self.wte = Embed(self.vocab_size + 1, embed_dim, device=device,
                         generator=gen)
        self.wpe = Embed(self.seq_len, embed_dim, device=device,
                         generator=gen)
        self.blocks = encoder_blocks(
            self, embed_dim, num_heads, num_layers, window=attn_window,
            lora_rank=lora_rank, lora_alpha=lora_alpha, attn_impl=attn_impl,
            device=device)
        for blk in self.blocks:
            init_flax_(blk, gen)
        self.ln_f = LayerNorm(embed_dim, device=device)
        self.mlm_dense = Dense(embed_dim, embed_dim, device=device,
                               generator=gen)
        self.mlm_ln = LayerNorm(embed_dim, device=device)
        self.mlm_head = Dense(embed_dim, self.vocab_size, device=device,
                              generator=gen)

    @property
    def device(self):
        return self.wte.embedding.device

    def forward(self, features, training=False):
        """features {"tokens": [b, l], optionally "segment_ids": [b, l]}
        -> fp32 MLM logits [b, l, vocab_size]. Under an sp mesh the
        features are this rank's sequence shard (see the module
        docstring)."""
        del training  # no dropout in the encoder
        refuse_mesh("bert", ("tp",))
        tokens = torch.as_tensor(features["tokens"],
                                 device=self.device).long()
        l = tokens.shape[1]
        mesh = current_mesh()
        if mesh is not None and mesh.size == 1:
            mesh = None
        sp, start = (1, 0) if mesh is None else (mesh.size, mesh.rank * l)
        if l * sp > self.seq_len:
            raise ValueError("length %d exceeds seq_len %d"
                             % (l * sp, self.seq_len))
        segments = features.get("segment_ids")
        if segments is None:
            positions = torch.arange(start, start + l, device=self.device)
            wpe_idx = positions[None]
        else:
            segments = torch.as_tensor(segments, device=self.device).to(
                torch.int32)
            full = segments if mesh is None else mesh.all_gather(segments, 1)
            positions = wpe_idx = packed_positions(full)[
                :, start:start + l].long()
        x = (self.wte(tokens).to(self.dtype)
             + self.wpe(wpe_idx).to(self.dtype))
        for blk in self.blocks:
            x, _rows = blk(x, positions, segments=segments)
        x = self.ln_f(x)
        x = F.gelu(_linear(self.mlm_dense, x), approximate="tanh")
        x = self.mlm_ln(x)
        return _linear(self.mlm_head, x).float()


def custom_model(**kwargs):
    return BertEncoder(**resolve_dtype(kwargs, "bert"))


def loss_parts(labels, predictions, sample_weights=None, mesh=None):
    """The loss in its partial form: (sum of ce * mask * w, sum of mask
    * w), whose quotient is `loss`. Under `mesh` (a dp x sp Mesh) the
    labels and logits are this rank's rows and sequence slice, and the
    denominator (which does not depend on the parameters) is summed
    over the world."""
    labels = torch.as_tensor(labels, device=predictions.device)
    mask = (labels != IGNORE_LABEL).float()
    ce = softmax_xent(predictions, labels.clamp(min=0)) * mask
    if sample_weights is not None:
        w = torch.as_tensor(sample_weights, device=predictions.device,
                            dtype=ce.dtype)[:, None]
        ce, mask = ce * w, mask * w
    den = mask.sum()
    if mesh is not None:
        den = mesh.all_reduce_sum(den.reshape(1), "world")[0]
    return ce.sum(), den.clamp(min=1.0)


def loss(labels, predictions, sample_weights=None):
    """Cross entropy over the masked positions only (labels ==
    IGNORE_LABEL elsewhere); with `sample_weights` [b], each row's
    positions weighted by its row's weight."""
    num, den = loss_parts(labels, predictions, sample_weights)
    return num / den


def optimizer(lr=1e-4):
    return adamw(lr, weight_decay=0.01)


def _mask_tokens(tokens, vocab_size, rng):
    """The 80/10/10 masking of one sequence: [MASK] is the reserved id
    `vocab_size`; random replacements come from the data vocabulary."""
    mask_id = vocab_size
    targets = rng.rand(tokens.size) < MASK_PROB
    labels = np.where(targets, tokens, IGNORE_LABEL).astype(np.int32)
    roll = rng.rand(tokens.size)
    masked = tokens.copy()
    masked[targets & (roll < 0.8)] = mask_id
    rand_pos = targets & (roll >= 0.8) & (roll < 0.9)
    masked[rand_pos] = rng.randint(0, vocab_size, size=int(rand_pos.sum()))
    return masked, labels


def dataset_fn(dataset, mode, metadata):
    def _parse(record):
        ex = decode_example(record)
        tokens = ex["tokens"].astype(np.int32)
        if mode == Mode.PREDICTION:
            return {"tokens": tokens}
        vocab = int(ex.get("vocab_size", np.array(256)))
        # static masking seeded by the record's content: the same record
        # masks the same way every epoch, records independently
        rng = np.random.RandomState(zlib.crc32(tokens.tobytes()) & 0x7FFFFFFF)
        masked, labels = _mask_tokens(tokens, vocab, rng)
        return {"tokens": masked}, labels

    dataset = dataset.map(_parse)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024, seed=0)
    return dataset


def eval_metrics_fn():
    def masked_accuracy(labels, predictions):
        labels = np.asarray(labels)
        preds = np.argmax(np.asarray(predictions), axis=-1)
        valid = labels != IGNORE_LABEL
        per_example = []
        for row_pred, row_label, row_valid in zip(preds, labels, valid):
            n = row_valid.sum()
            if n == 0:
                continue  # nothing masked: no opinion
            per_example.append(
                float((row_pred[row_valid] == row_label[row_valid]).sum())
                / n)
        return np.asarray(per_example, np.float32)

    return {"masked_token_accuracy": masked_accuracy}


flax_param_path = zoo_flax_param_path


def feature_shapes(seq_len=128):
    return {"tokens": (seq_len,)}
