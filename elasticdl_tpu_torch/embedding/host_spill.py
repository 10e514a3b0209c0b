"""Host-spill embedding engine: tables too large for the card. The
port's copy of elasticdl_tpu/embedding/host_spill.py.

The third tier of the sparse embedding design (embedding/layer.py holds
tables in device memory; this holds host-DRAM tables), playing the role
parameter-server pod memory played in ElasticDL: rows live on the host
(native/host_embedding.py's store), the card only ever sees the rows a
batch touches.

Two phases around the step on the card:

    unique_ids, rows, inverse = engine.pull(batch_ids)
    # card: embed = rows[inverse]; forward and backward;
    # the gradient comes back per unique row (pull already deduped)
    engine.apply_gradients(unique_ids, row_grads)

Optimizer slots live on the host beside the rows, each a store that
starts at zero lazily.
"""

import numpy as np

from elasticdl_tpu_torch.native.host_embedding import HostEmbeddingStore

_SLOT_NAMES = {
    "sgd": (),
    "momentum": ("momentum",),
    "adam": ("m", "v"),
    "adagrad": ("accumulator",),
}


class HostSpillEmbeddingEngine(object):
    def __init__(self, dim, optimizer="adam", seed=0,
                 init_low=-0.05, init_high=0.05, force_python=False,
                 **hyperparams):
        if optimizer not in _SLOT_NAMES:
            raise ValueError(
                "Unknown optimizer %r (supported: %s)"
                % (optimizer, sorted(_SLOT_NAMES)))
        self.dim = dim
        self.optimizer = optimizer
        self.hyperparams = hyperparams
        self._ctor_kwargs = dict(seed=seed, init_low=init_low,
                                 init_high=init_high,
                                 force_python=force_python)
        self.param = HostEmbeddingStore(
            dim, seed=seed, init_low=init_low, init_high=init_high,
            force_python=force_python)
        self.slots = {
            name: HostEmbeddingStore(dim, seed=seed, init_low=0.0,
                                     init_high=0.0,
                                     force_python=force_python)
            for name in _SLOT_NAMES[optimizer]
        }
        self._step = 0

    def fresh_clone(self):
        """A new empty engine with this one's configuration: what a
        restore that must not touch the live stores fills."""
        return HostSpillEmbeddingEngine(
            self.dim, optimizer=self.optimizer, **self._ctor_kwargs,
            **self.hyperparams)

    # ------------------------------------------------------------- pull

    def pull(self, ids):
        """Dedup `ids` (any shape) and fetch their rows. Returns
        (unique_ids [k] sorted, rows [k, dim] float32, inverse with the
        ids' shape), so the card computes rows[inverse]."""
        ids = np.asarray(ids, np.int64)
        unique_ids, inverse = np.unique(ids, return_inverse=True)
        rows = self.param.lookup(unique_ids)
        return unique_ids, rows, inverse.reshape(ids.shape)

    # ------------------------------------------------------- apply grads

    def apply_gradients(self, unique_ids, row_grads, lr=None, lr_scale=1.0):
        """Apply per-unique-row gradients with the engine's optimizer;
        only these rows and their slots move. `lr` overrides the
        configured rate; `lr_scale` multiplies it (the Trainer's
        learning-rate schedule)."""
        self._step += 1
        hp = dict(self.hyperparams)
        if lr is not None:
            hp["lr"] = lr
        hp.setdefault("lr", 0.001 if self.optimizer == "adam" else 0.1)
        hp["lr"] = hp["lr"] * float(lr_scale)
        if self.optimizer == "sgd":
            self.param.sgd(unique_ids, row_grads, hp["lr"])
        elif self.optimizer == "momentum":
            self.param.momentum(
                self.slots["momentum"], unique_ids, row_grads, hp["lr"],
                hp.get("momentum", 0.9), hp.get("nesterov", False))
        elif self.optimizer == "adam":
            self.param.adam(
                self.slots["m"], self.slots["v"], unique_ids, row_grads,
                hp["lr"], hp.get("beta1", 0.9), hp.get("beta2", 0.999),
                hp.get("eps", 1e-8), step=self._step)
        else:
            self.param.adagrad(
                self.slots["accumulator"], unique_ids, row_grads,
                hp["lr"], hp.get("eps", 1e-10))

    # ------------------------------------------------------- checkpoint

    def state_dict(self):
        """{"step": int, "param": (ids, values), <slot>: (ids, values)}:
        the checkpoint payload, the JAX engine's layout."""
        out = {"step": self._step, "param": self.param.export_rows()}
        for name, store in self.slots.items():
            out[name] = store.export_rows()
        return out

    def load_state_dict(self, state):
        """Restore REPLACES the stores' contents: rows made since the
        checkpoint go back to their lazy initial values, so a restore
        into a used engine equals one into a fresh engine."""
        self._step = int(state["step"])
        for name, store in [("param", self.param)] + list(
                self.slots.items()):
            ids, values = state[name]
            store.clear()
            store.set_rows(ids, values)
