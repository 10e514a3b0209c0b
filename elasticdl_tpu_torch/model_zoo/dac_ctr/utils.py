"""Shared CTR building blocks: the PyTorch twins of
model_zoo/dac_ctr/utils.py (the reference's utils.py DNN and
lookup_embedding_func, and the interaction layers it imports from the
`deepctr` package: FM, CrossNet, CIN).

The dense products (the DNN, the CrossNet's x . w, the CIN's outer
product and compression) are plain torch products, as the JAX package
computes them outside any Pallas kernel. Modules and parameters carry
the flax names; parameters are drawn from the generator they are given,
in the order they are built.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.model_zoo.flax_layers import Dense, Embed


class DNN(nn.Module):
    """A stack of Dense layers `Dense_i` (reference utils.py DNN), each
    followed by `activation` ("relu" or None)."""

    def __init__(self, n_in, hidden_units, activation=None, device=None,
                 generator=None):
        super().__init__()
        if activation not in ("relu", None):
            raise KeyError(activation)
        self.activation = activation
        self.n_layers = len(hidden_units)
        for i, units in enumerate(hidden_units):
            self.add_module("Dense_%d" % i, Dense(n_in, units, device=device,
                                                  generator=generator))
            n_in = units

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, "Dense_%d" % i)(x)
            if self.activation == "relu":
                x = torch.relu(x)
        return x


def _by_group_number(names):
    return sorted(names, key=lambda n: int(n.split("_")[-1]))


class GroupEmbeddings(nn.Module):
    """A table `<group>_dim<d>_embedding` a group of `max_ids` ({group
    name: id-space size}), looked up and summed over the group's
    features (reference utils.py lookup_embedding_func). Call with the
    {group name: [batch, n_feat] ids} dict; returns a [batch, d] tensor a
    group, in group-number order."""

    def __init__(self, max_ids, embedding_dim, device=None, generator=None):
        super().__init__()
        self.embedding_dim = int(embedding_dim)
        for name in _by_group_number(max_ids):
            self.add_module(self._table(name), Embed(
                max_ids[name], embedding_dim, device, generator))

    def _table(self, name):
        return "%s_dim%d_embedding" % (name, self.embedding_dim)

    def forward(self, id_tensors):
        return [getattr(self, self._table(name))(id_tensors[name]).sum(dim=1)
                for name in _by_group_number(id_tensors)]


class FM(nn.Module):
    """The factorization-machine pairwise term over stacked field
    embeddings (deepctr FM): [B, F, D] -> 0.5 * sum_d((sum_f e)^2 -
    sum_f e^2) -> [B, 1]."""

    def forward(self, stacked):
        sum_sq = stacked.sum(dim=1).square()
        sq_sum = stacked.square().sum(dim=1)
        return 0.5 * (sum_sq - sq_sum).sum(dim=1, keepdim=True)


class CrossNet(nn.Module):
    """The DCN cross network (deepctr CrossNet): x_{l+1} = x_0 (x_l . w_l)
    + b_l + x_l, with `cross_w_l` normal(0.01) and `cross_b_l` zero, both
    [dim]."""

    def __init__(self, dim, num_layers=2, device=None, generator=None):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            w = torch.empty((dim,), device=device)
            with torch.no_grad():
                w.normal_(0.0, 0.01, generator=generator)
            self.register_parameter("cross_w_%d" % layer, nn.Parameter(w))
            self.register_parameter("cross_b_%d" % layer, nn.Parameter(
                torch.zeros((dim,), device=device)))

    def forward(self, x0):
        x = x0
        for layer in range(self.num_layers):
            xw = (x @ getattr(self, "cross_w_%d" % layer))[:, None]  # [B, 1]
            x = x0 * xw + getattr(self, "cross_b_%d" % layer) + x
        return x


class CIN(nn.Module):
    """The compressed interaction network of xDeepFM (deepctr CIN, the
    plain variant the JAX package builds): input [B, F, D]; layer k
    compresses the outer product of the previous feature maps [B, h_k,
    D] with X^0 along the field axes by `cin_w_k` [size_k, h_k F]
    (normal(0.01)); each layer's maps are sum-pooled over D, and the
    pools concatenated -> [B, sum(sizes)]."""

    def __init__(self, fields, layer_sizes=(128, 128), device=None,
                 generator=None):
        super().__init__()
        self.layer_sizes = tuple(layer_sizes)
        hk = fields
        for k, size in enumerate(self.layer_sizes):
            w = torch.empty((size, hk * fields), device=device)
            with torch.no_grad():
                w.normal_(0.0, 0.01, generator=generator)
            self.register_parameter("cin_w_%d" % k, nn.Parameter(w))
            hk = size

    def forward(self, x0):
        batch, fields, dim = x0.shape
        finals = []
        xk = x0
        for k in range(len(self.layer_sizes)):
            hk = xk.shape[1]
            # the outer product along the field axes: [B, hk, F, D]
            z = torch.einsum("bhd,bfd->bhfd", xk, x0)
            z = z.reshape(batch, hk * fields, dim)
            xk = torch.einsum("bmd,sm->bsd", z,
                              getattr(self, "cin_w_%d" % k))  # [B, size, D]
            finals.append(xk.sum(dim=2))  # sum pool over D
        return torch.cat(finals, dim=1)  # [B, sum(sizes)]


DEEP_EMBEDDING_DIM = 8
DENSE_DIM = 13  # the standardized numerics
DNN_UNITS = (16, 4)


class CTRModel(nn.Module):
    """What the four CTR models share (reference wide_deep_model.py and
    its siblings): the dim-1 tables' sums (`GroupEmbeddings_0`) and
    `Dense_0` (1, no bias) over the dense tensor are the linear logits;
    the dense tensor and the dim-8 tables' sums (`GroupEmbeddings_1`)
    are the deep input of `DNN_0`; `Dense_1` (1, no bias) over
    `head_width` features is the deep logit. Subclasses add their
    interaction layers and `logit_parts`. The JAX models also take no
    dense tensor (None), which no caller passes; the port always takes
    it."""

    def __init__(self, max_ids, head_width=DNN_UNITS[-1], device=None,
                 generator=None):
        super().__init__()
        self.n_fields = len(max_ids)
        self.deep_width = self.deep_width_of(max_ids)
        self.GroupEmbeddings_0 = GroupEmbeddings(max_ids, 1, device,
                                                 generator)
        self.GroupEmbeddings_1 = GroupEmbeddings(
            max_ids, DEEP_EMBEDDING_DIM, device, generator)
        self.Dense_0 = Dense(DENSE_DIM, 1, use_bias=False, device=device,
                             generator=generator)
        self.DNN_0 = DNN(self.deep_width, DNN_UNITS, "relu", device,
                         generator)
        self.Dense_1 = Dense(head_width, 1, use_bias=False, device=device,
                             generator=generator)

    @staticmethod
    def deep_width_of(max_ids):
        """The deep input's width: the dense tensor and a dim-8 sum a
        group."""
        return DENSE_DIM + len(max_ids) * DEEP_EMBEDDING_DIM

    def logit_parts(self, dnn_input, deep_embeddings):
        raise NotImplementedError

    def forward(self, dense_tensor, id_tensors, training=False):
        del training
        linear_logits = self.GroupEmbeddings_0(id_tensors)
        deep_embeddings = self.GroupEmbeddings_1(id_tensors)
        dnn_input = torch.cat([dense_tensor] + deep_embeddings, dim=-1)
        linear_logits.append(self.Dense_0(dense_tensor))
        parts = [torch.cat(linear_logits, dim=-1)]
        parts += self.logit_parts(dnn_input, deep_embeddings)
        logits = torch.cat(parts, dim=1).sum(dim=1, keepdim=True)
        return {"logits": logits, "probs": torch.sigmoid(logits).reshape(-1)}
