"""The port's device mesh over torch.distributed, the counterpart of
elasticdl_tpu/parallel/mesh.py for the `sp` (sequence / context) axis
only.

`build_mesh({"sp": n})` over an initialized `torch.distributed` world
of n processes (gloo) gives a `Mesh` that holds this rank and the size. Used as a context manager it is `current_mesh()` inside the
block, as JAX's `with mesh:` is: the Trainer enters it around its step,
and the model's attention reads it to route to ring attention or
Ulysses (parallel/context_parallel.py). Every other axis is one; a mesh
that sets one above one raises (dp, fsdp, ep, tp and pp over
torch.distributed are ROADMAP Queue 1 item 6).

The collectives the sp path needs (the ring's neighbour shift, Ulysses'
all-to-all, an all-gather and a sum) are methods of the mesh, and all of
them cross processes through `Mesh._exchange`.
"""

import contextvars

import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.constants import MeshAxis

_CURRENT = contextvars.ContextVar("elasticdl_tpu_torch_mesh", default=None)


def current_mesh():
    """The Mesh entered with `with mesh:` in this context, or None."""
    return _CURRENT.get()


class Mesh(object):
    """The sp ranks of the world process group. `shape`: {axis: size}
    over MeshAxis.ALL, every axis but sp of size 1; `rank` and `size`
    are this process's place on the sp axis and the axis' length."""

    def __init__(self, sp):
        self.shape = dict.fromkeys(MeshAxis.ALL, 1)
        self.shape[MeshAxis.SP] = int(sp)
        self.size = int(sp)
        self.rank = dist.get_rank() if self.size > 1 else 0
        self._tokens = []

    def __enter__(self):
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._tokens.pop())
        return False

    # ------------------------------------------------------ collectives

    def _exchange(self, tensors, op):
        """Run the collective `op` (host tensors in, host tensors out)
        over `tensors` and return its results on the tensors' device.

        This is the one place where the port's sp path crosses processes.
        gloo moves only host tensors, and the card's machine has one GPU,
        on which NCCL cannot place two ranks. So the exchange copies CUDA
        tensors into host memory, runs `op` over gloo and copies the
        results back to the card: the compute stays on the card and only
        the exchanged shards pass through the host. An exchange between
        cards (NCCL, one card per rank) is ROADMAP work."""
        device = tensors[0].device
        host = [t.detach().to("cpu").contiguous() for t in tensors]
        return [t.to(device) for t in op(host)]

    def ring_shift(self, tensors):
        """Send each tensor to the previous rank of the ring and receive
        the next rank's (rank r ends up with what rank r + 1 held), as
        the JAX ring's ppermute over perm (j + 1 -> j) does."""
        prev = (self.rank - 1) % self.size
        nxt = (self.rank + 1) % self.size

        def op(host):
            recv = [torch.empty_like(t) for t in host]
            ops = ([dist.P2POp(dist.isend, t, prev) for t in host]
                   + [dist.P2POp(dist.irecv, t, nxt) for t in recv])
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return recv

        return self._exchange(tensors, op)

    def all_to_all(self, x, split_dim, cat_dim):
        """Split `x` into `size` equal chunks along `split_dim`, send
        chunk j to rank j, and concatenate what arrives along `cat_dim`
        in rank order (jax.lax.all_to_all with tiled=True)."""

        def op(host):
            # point to point: gloo has no alltoall in every PyTorch
            recv = [t if j == self.rank else torch.empty_like(t)
                    for j, t in enumerate(host)]
            ops = []
            for j in range(self.size):
                if j != self.rank:
                    ops.append(dist.P2POp(dist.isend, host[j], j))
                    ops.append(dist.P2POp(dist.irecv, recv[j], j))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return recv

        chunks = list(x.chunk(self.size, dim=split_dim))
        return torch.cat(self._exchange(chunks, op), dim=cat_dim)

    def all_gather(self, x, dim):
        """Every rank's `x` concatenated along `dim` in rank order."""

        def op(host):
            recv = [torch.empty_like(host[0]) for _ in range(self.size)]
            dist.all_gather(recv, host[0])
            return recv

        return torch.cat(self._exchange([x], op), dim=dim)

    def all_reduce_sum(self, x):
        """The sum of every rank's `x`, the same on every rank."""

        def op(host):
            total = host[0].clone()
            dist.all_reduce(total)
            return [total]

        return self._exchange([x], op)[0]


def build_mesh(mesh_spec):
    """A Mesh from {axis: size} over the world group of torch.distributed.
    Axes left out are 1. sp > 1 needs an initialized gloo group of
    exactly sp processes; any other axis above 1 raises
    NotImplementedError."""
    sizes = dict.fromkeys(MeshAxis.ALL, 1)
    for axis, value in dict(mesh_spec).items():
        if axis not in sizes:
            raise ValueError("Unknown mesh axis %r (valid: %s)"
                             % (axis, MeshAxis.ALL))
        sizes[axis] = int(value)
    others = {a: n for a, n in sizes.items() if a != MeshAxis.SP and n != 1}
    if others:
        raise NotImplementedError(
            "the port's mesh runs the sp axis only; %s over "
            "torch.distributed is not ported (ROADMAP Queue 1 item 6)"
            % others)
    sp = sizes[MeshAxis.SP]
    if sp < 1:
        raise ValueError("sp must be >= 1, got %d" % sp)
    if sp == 1:
        return Mesh(1)
    if not dist.is_initialized():
        raise RuntimeError(
            "sp = %d needs torch.distributed.init_process_group('gloo', "
            "...) over %d processes first" % (sp, sp))
    backend = dist.get_backend()
    if backend != "gloo":
        raise NotImplementedError(
            "the sp exchange runs over gloo (host-staged); a %r group is "
            "not ported (ROADMAP)" % backend)
    n = dist.get_world_size()
    if n != sp:
        raise ValueError("mesh sp = %d needs a group of %d processes, got %d"
                         % (sp, sp, n))
    return Mesh(sp)
