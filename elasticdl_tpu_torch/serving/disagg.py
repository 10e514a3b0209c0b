"""Disaggregated prefill/decode serving, the KV chain handoff: the port of
elasticdl_tpu/serving/disagg.py.

Prefill is compute-bound and decode memory-bound, so a fleet may split
them across replicas:

* a replica advertises a ROLE (`prefill`, `decode` or `unified`;
  ServingConfig.role -> ServerStatus.role): a router keeps `prefill`
  replicas out of normal rotation and targets them only for cache
  warming;
* a prefill replica runs a prompt with `GenerateRequest.prefill_only`:
  seat, prefill, register the chain, release, leaving the chain parked
  refcount-0 cached (matchable, exportable, reclaimable);
* the chain moves as a DENSE BYTE COPY: `export_chain` gathers its
  blocks (int8 rows and fp32 scales alike, through the host spill
  tier's gather) into a `TransferChainRequest`; `transfer_chain` on the
  decode side lands them in one batched upload into fresh blocks
  re-keyed into its content-addressed trie. The next generate with that
  prompt seats by prefix hit, so the handoff is token-exact as prefix
  sharing is.

HandoffCoordinator drives one handoff: `export_chain` must be settled by
`import_chain` (success) or `abort_transfer` (the failure's record).
Exports hold no pool references, so a crash mid-transfer leaks nothing.

Wire codec: a block's rows travel as raw little-endian bytes per row
leaf (`KvChainBlock.leaves`, in the JAX package's `jax.tree.leaves`
order, serving/kv_pool.wire_order) beside the dtype names, so the
importer refuses a mismatched layout cheaply; the replica answers such a
payload `ok=False`, never an RPC error. bfloat16 has no numpy dtype: a
leaf's bytes are its tensor's raw 16-bit patterns, read back through an
int16 view, the bytes ml_dtypes writes for the JAX package.
"""

import itertools
import logging
import threading

import numpy as np
import torch

from elasticdl_tpu_torch.proto import messages as pb

logger = logging.getLogger(__name__)

# the row-leaf dtypes a chain carries: name -> (numpy dtype of the raw
# bytes, torch dtype of the rows)
_LEAF_DTYPES = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float16": (np.float16, torch.float16),
    "float32": (np.float32, torch.float32),
    "int8": (np.int8, torch.int8),
}


class HandoffError(Exception):
    """A handoff leg failed (prefill generate, export or import). The
    caller falls back to a plain dispatch: a failed handoff costs the
    warm start, never the request."""


def _leaf_bytes(rows):
    """A row leaf's raw bytes (a CPU tensor of any dtype, bf16 too)."""
    rows = rows.detach().to("cpu").contiguous()
    return rows.reshape(-1).view(torch.uint8).numpy().tobytes()


def chain_to_proto(chain, block_size, leaf_dtypes, transfer_id):
    """Serialize a pool export (`[(block token tuple, [CPU rows per
    leaf])]`, PagedKVPool.export_chain's shape) into the payload the
    decode side imports verbatim."""
    return pb.TransferChainRequest(
        transfer_id=transfer_id,
        block_size=block_size,
        leaf_dtypes=list(leaf_dtypes),
        blocks=[pb.KvChainBlock(tokens=list(toks),
                                leaves=[_leaf_bytes(r) for r in rows])
                for toks, rows in chain],
    )


def proto_to_blocks(msg, pool):
    """Decode a TransferChainRequest against the IMPORTING pool's own
    geometry: each leaf's bytes take that pool's per-block row shape, so
    a size mismatch (other model dims, another block_size) raises a
    ValueError the servicer answers as ok=False. Returns (blocks,
    leaf_dtypes) in import_chain's argument shape."""
    shapes = pool.leaf_shapes()
    dtypes = list(msg.leaf_dtypes)
    if len(dtypes) != len(shapes):
        raise ValueError("chain carries %d row leaves, this pool has %d"
                         % (len(dtypes), len(shapes)))
    if msg.block_size != pool.block_size:
        raise ValueError("chain block_size %d does not match this pool's %d"
                         % (msg.block_size, pool.block_size))
    kinds = []
    for dt in dtypes:
        if dt not in _LEAF_DTYPES:
            raise ValueError("chain leaf dtype %r is not a KV arena dtype"
                             % (dt,))
        kinds.append(_LEAF_DTYPES[dt])
    blocks = []
    for blk in msg.blocks:
        if len(blk.leaves) != len(shapes):
            raise ValueError("chain block carries %d leaves, expected %d"
                             % (len(blk.leaves), len(shapes)))
        rows = []
        for raw, (np_dt, torch_dt), shape in zip(blk.leaves, kinds, shapes):
            arr = np.frombuffer(raw, dtype=np_dt)
            if arr.size != int(np.prod(shape)):
                raise ValueError(
                    "chain leaf holds %d values, this pool's block %s"
                    % (arr.size, shape))
            rows.append(torch.from_numpy(arr.reshape(shape).copy())
                        .view(torch_dt))
        blocks.append((tuple(blk.tokens), rows))
    return blocks, dtypes


class HandoffCoordinator(object):
    """One prefill -> decode handoff and its three obligations, against
    replicas that offer the ServingStub surface (generate / export_chain
    / transfer_chain / abort_transfer, each taking `timeout=`) as
    `rep.stub`. Transfer ids are unique across the process."""

    _ids = itertools.count(1)
    _ids_lock = threading.Lock()

    def __init__(self, timeout_secs=10.0):
        self.timeout_secs = float(timeout_secs)

    def new_transfer_id(self):
        with HandoffCoordinator._ids_lock:
            return "xfer-%d" % next(HandoffCoordinator._ids)

    def export_chain(self, rep, request, transfer_id, timeout=None):
        """Warm the prefill replica and export the chain: one
        prefill_only generate (its sampled token is discarded; the
        decode side re-derives it from the shared chain, which is what
        makes the handoff token-exact), then the export call. Returns
        the payload; settle it with import_chain or abort_transfer."""
        timeout = self.timeout_secs if timeout is None else timeout
        rep.stub.generate(
            pb.GenerateRequest(
                prompt=list(request.prompt),
                max_new_tokens=1,
                temperature=request.temperature,
                seed=request.seed,
                prefill_only=True,
            ),
            timeout=timeout,
        )
        payload = rep.stub.export_chain(
            pb.ExportChainRequest(prompt=list(request.prompt),
                                  transfer_id=transfer_id),
            timeout=timeout,
        )
        if not payload.blocks:
            raise HandoffError("prefill replica exported an empty chain")
        return payload

    def import_chain(self, rep, payload, timeout=None):
        """Land an exported chain on the decode replica (the success
        settle). The response's `blocks` is the chain's coverage on the
        importer, imported plus already resident levels, so a fully
        deduped transfer succeeds. Raises HandoffError when the importer
        refused the payload or none of the chain landed."""
        timeout = self.timeout_secs if timeout is None else timeout
        resp = rep.stub.transfer_chain(payload, timeout=timeout)
        if not resp.ok or not resp.blocks:
            raise HandoffError("decode replica refused chain import: %s"
                               % (resp.error or "no blocks imported",))
        return resp

    def abort_transfer(self, rep, transfer_id, timeout=None):
        """Close a failed handoff on the exporter (the failure settle).
        Best-effort: the exporter holds no references for it, so a lost
        abort only costs the failure its ledger entry."""
        timeout = self.timeout_secs if timeout is None else timeout
        try:
            rep.stub.abort_transfer(
                pb.AbortTransferRequest(transfer_id=transfer_id),
                timeout=timeout,
            )
        except Exception as e:  # noqa: BLE001 - accounting only
            logger.debug("abort_transfer(%s) to %s failed: %r",
                         transfer_id, rep.address, e)
