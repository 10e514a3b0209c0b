"""The port's device mesh over torch.distributed, the counterpart of
elasticdl_tpu/parallel/mesh.py for the `dp` (data) and `sp` (sequence /
context) axes.

`build_mesh({"dp": m, "sp": n})` (or a "dp=2,sp=2" spec string, as
`parse_mesh_spec` reads it) over an initialized `torch.distributed`
world of m * n processes (gloo) gives a `Mesh` that holds this rank's
place on each axis. The ranks are laid out as JAX's reshape of the
device list in MeshAxis.ALL order lays them out: dp outer, sp inner, so
world rank = dp_rank * sp + sp_rank. Used as a context manager it is
`current_mesh()` inside the block, as JAX's `with mesh:` is: the
Trainer enters it around its step, and the model's attention reads it
to route to ring attention or Ulysses (parallel/context_parallel.py).
fsdp, ep, tp and pp above one raise (ROADMAP Queue 1 item 7).

`rank` and `size` are the sp axis' (what the ring, Ulysses and the
models read); `dp_rank` / `dp_size` and `world_rank` / `world_size`
are the others. The collectives (the ring's neighbour shift, Ulysses'
all-to-all, an all-gather and a sum over an axis, a barrier) are
methods of the mesh, and all of them cross processes through
`Mesh._exchange`. Point-to-point ops name global ranks; a gather or a
sum runs over the process group of its axis.
"""

import contextvars
import math

import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.constants import MeshAxis

# the ROADMAP item that the axes the port does not run wait for
MESH_ITEM = "ROADMAP Queue 1 item 7"

_CURRENT = contextvars.ContextVar("elasticdl_tpu_torch_mesh", default=None)

WORLD = "world"


def current_mesh():
    """The Mesh entered with `with mesh:` in this context, or None."""
    return _CURRENT.get()


def parse_mesh_spec(spec):
    """'dp=4,sp=2' style mesh specs -> {axis: size} over MeshAxis.ALL
    (the JAX package's parse_mesh_spec). -1 (at most once) fills the
    axis with the remaining processes; an empty spec is dp=-1."""
    sizes = {ax: 1 for ax in MeshAxis.ALL}
    if not spec:
        sizes[MeshAxis.DP] = -1
        return sizes
    seen_fill = False
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        ax, _, val = part.partition("=")
        ax = ax.strip()
        if ax not in sizes:
            raise ValueError(
                "Unknown mesh axis %r (valid: %s)" % (ax, MeshAxis.ALL))
        val = int(val)
        if val == -1:
            if seen_fill:
                raise ValueError("Only one mesh axis may be -1")
            seen_fill = True
        sizes[ax] = val
    if not seen_fill and math.prod(v for v in sizes.values()) <= 0:
        raise ValueError("Invalid mesh spec %r" % spec)
    return sizes


class Mesh(object):
    """dp x sp ranks of the world process group. `shape`: {axis: size}
    over MeshAxis.ALL, every axis but dp and sp of size 1; `rank` and
    `size` are this process's place on the sp axis and the axis' length,
    `dp_rank` and `dp_size` the dp axis', `world_rank` and `world_size`
    the group's."""

    def __init__(self, dp=1, sp=1):
        dp, sp = int(dp), int(sp)
        self.shape = dict.fromkeys(MeshAxis.ALL, 1)
        self.shape[MeshAxis.DP] = dp
        self.shape[MeshAxis.SP] = sp
        self.size, self.dp_size = sp, dp
        self.world_size = dp * sp
        self.world_rank = dist.get_rank() if self.world_size > 1 else 0
        self.dp_rank, self.rank = divmod(self.world_rank, sp)
        # None is the world group: an axis that spans the world (or a
        # size-1 axis, which never exchanges) needs no group of its own
        self._groups = {MeshAxis.SP: None, MeshAxis.DP: None, WORLD: None}
        if dp > 1 and sp > 1:
            # new_group is a collective over the world: every rank makes
            # every group, in the same order, and keeps its own
            for d in range(dp):
                group = dist.new_group([d * sp + s for s in range(sp)])
                if d == self.dp_rank:
                    self._groups[MeshAxis.SP] = group
            for s in range(sp):
                group = dist.new_group([d * sp + s for d in range(dp)])
                if s == self.rank:
                    self._groups[MeshAxis.DP] = group
        self._tokens = []

    def __enter__(self):
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._tokens.pop())
        return False

    def axis_size(self, axis):
        """The length of `axis` ("sp", "dp" or "world")."""
        return {MeshAxis.SP: self.size, MeshAxis.DP: self.dp_size,
                WORLD: self.world_size}[axis]

    def _global(self, sp_rank):
        """The world rank of sp rank `sp_rank` in this rank's dp
        replica."""
        return self.dp_rank * self.size + sp_rank

    # ------------------------------------------------------ collectives

    def _exchange(self, tensors, op):
        """Run the collective `op` (host tensors in, host tensors out)
        over `tensors` and return its results on the tensors' device.

        This is the one place where the port's mesh crosses processes.
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
        """Send each tensor to the previous rank of the sp ring and
        receive the next rank's (sp rank r ends up with what r + 1
        held), as the JAX ring's ppermute over perm (j + 1 -> j) does."""
        prev = self._global((self.rank - 1) % self.size)
        nxt = self._global((self.rank + 1) % self.size)

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
        chunk j to sp rank j, and concatenate what arrives along
        `cat_dim` in sp rank order (jax.lax.all_to_all with
        tiled=True)."""

        def op(host):
            # point to point: gloo has no alltoall in every PyTorch
            recv = [t if j == self.rank else torch.empty_like(t)
                    for j, t in enumerate(host)]
            ops = []
            for j in range(self.size):
                if j != self.rank:
                    peer = self._global(j)
                    ops.append(dist.P2POp(dist.isend, host[j], peer))
                    ops.append(dist.P2POp(dist.irecv, recv[j], peer))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return recv

        chunks = list(x.chunk(self.size, dim=split_dim))
        return torch.cat(self._exchange(chunks, op), dim=cat_dim)

    def all_gather(self, x, dim, axis=MeshAxis.SP):
        """Every rank's `x` of `axis` concatenated along `dim` in rank
        order."""
        n = self.axis_size(axis)
        if n == 1:
            return x

        def op(host):
            recv = [torch.empty_like(host[0]) for _ in range(n)]
            dist.all_gather(recv, host[0], group=self._groups[axis])
            return recv

        return torch.cat(self._exchange([x], op), dim=dim)

    def all_reduce_sum(self, x, axis=MeshAxis.SP):
        """The sum of `x` over the ranks of `axis`, the same on each."""
        if self.axis_size(axis) == 1:
            return x

        def op(host):
            total = host[0].clone()
            dist.all_reduce(total, group=self._groups[axis])
            return [total]

        return self._exchange([x], op)[0]

    def barrier(self):
        """Wait until every rank of the world is here."""
        if self.world_size > 1:
            dist.barrier()


def build_mesh(mesh_spec=None):
    """A Mesh from {axis: size} (axes left out are 1) or a spec string
    (`parse_mesh_spec`; -1 fills with the world's processes) over the
    world group of torch.distributed. dp * sp > 1 needs an initialized
    gloo group of exactly dp * sp processes; fsdp, ep, tp or pp above 1
    raises NotImplementedError."""
    if isinstance(mesh_spec, dict):
        sizes = dict.fromkeys(MeshAxis.ALL, 1)
        for axis, value in mesh_spec.items():
            if axis not in sizes:
                raise ValueError("Unknown mesh axis %r (valid: %s)"
                                 % (axis, MeshAxis.ALL))
            sizes[axis] = int(value)
    else:
        sizes = parse_mesh_spec(mesh_spec)
    if -1 in sizes.values():
        n = dist.get_world_size() if dist.is_initialized() else 1
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if n % fixed:
            raise ValueError("Cannot fill a mesh axis: %d processes not "
                             "divisible by %d" % (n, fixed))
        sizes = {a: n // fixed if v == -1 else v for a, v in sizes.items()}
    others = {a: n for a, n in sizes.items()
              if a not in (MeshAxis.DP, MeshAxis.SP) and n != 1}
    if others:
        raise NotImplementedError(
            "the port's mesh runs the dp and sp axes; %s over "
            "torch.distributed is not ported (%s)" % (others, MESH_ITEM))
    dp, sp = sizes[MeshAxis.DP], sizes[MeshAxis.SP]
    for axis, value in ((MeshAxis.DP, dp), (MeshAxis.SP, sp)):
        if value < 1:
            raise ValueError("%s must be >= 1, got %d" % (axis, value))
    if dp * sp == 1:
        return Mesh()
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh dp = %d, sp = %d needs torch.distributed."
            "init_process_group('gloo', ...) over %d processes first"
            % (dp, sp, dp * sp))
    backend = dist.get_backend()
    if backend != "gloo":
        raise NotImplementedError(
            "the mesh's exchange runs over gloo (host-staged); a %r group "
            "is not ported (ROADMAP)" % backend)
    n = dist.get_world_size()
    if n != dp * sp:
        raise ValueError("mesh dp = %d x sp = %d needs a group of %d "
                         "processes, got %d" % (dp, sp, dp * sp, n))
    return Mesh(dp, sp)
