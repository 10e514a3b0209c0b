"""Row-sparse optimizer semantics for embedding tables of the dense
tier: the counterpart of elasticdl_tpu/embedding/sparse_optim.py
(`make_row_sparse`).

A dense optimizer step over a [vocab, dim] table moves every row (Adam's
moment decay and bias correction, weight decay); the reference's
OptimizerWrapper moves only the rows a minibatch touched, with their
slots. `masked_step` keeps that contract for the embedding tables the
torch optimizer holds (the untapped ones, under 2 MiB unless
`sparse_grads=False`): a row whose gradient is exactly zero keeps its
value and its slot rows; scalar state (Adam's step) advances globally.
"""

import contextlib

import torch


def _row_mask(grad):
    """[vocab, 1, ...] bool: True where any element of the row is
    nonzero."""
    flat = grad.reshape(grad.shape[0], -1)
    return (flat != 0).any(dim=1).reshape((-1,) + (1,) * (grad.dim() - 1))


def _row_slots(optimizer, p):
    return {k: v for k, v in optimizer.state.get(p, {}).items()
            if torch.is_tensor(v) and v.shape == p.shape}


@contextlib.contextmanager
def masked_step(optimizer, tables):
    """Wrap `optimizer.step()`: snapshot each table of `tables` and its
    slot tables before, then restore the rows whose gradient is all zero
    with torch.where(row_mask, new, old). A slot the step creates (torch
    makes them lazily) is restored to zeros, optax's initial value."""
    saved = []
    with torch.no_grad():
        for p in tables:
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            slots = {k: v.clone() for k, v in _row_slots(optimizer, p).items()}
            saved.append((p, _row_mask(grad), p.detach().clone(), slots))
    yield
    with torch.no_grad():
        for p, mask, old, slots in saved:
            p.copy_(torch.where(mask, p, old))
            for k, v in _row_slots(optimizer, p).items():
                prev = slots.get(k)
                v.copy_(torch.where(mask, v, prev if prev is not None
                                    else torch.zeros_like(v)))
