"""Prefix-affinity primitives of the router: the port of
elasticdl_tpu/serving/prefix_affinity.py, digest for digest.

``prefix_fingerprint``
    Hashes a request's leading full KV blocks as a chain
    ``H(parent_digest || block_tokens)`` (blake2b, 8 bytes, each token
    packed as ``<q``) seeded by the trie's root-parent sentinel, so two
    prompts share a fingerprint exactly when their leading block chain
    would share trie nodes on a replica. A prompt shorter than one full
    block has none (None): the router routes it by load. A fingerprint
    is a key across processes, so it must equal the JAX package's.

``HashRing``
    A deterministic consistent-hash ring (blake2b points, never the
    salted builtin ``hash``) with virtual nodes; ``successors`` yields
    the distinct nodes in ring order, the failover walk.

``AffinityIndex``
    A TTL'd, capacity-bounded LRU of fingerprint -> replica address,
    learned on successful dispatch; an expired or evicted entry falls
    back to least-loaded routing.
"""

import bisect
import hashlib
import struct
import threading
from collections import OrderedDict

#: the trie's root-parent sentinel: the first block's digest depends
#: only on its tokens
_ROOT_DIGEST = b"\xff" * 8

#: digest width (a collision costs one misrouted dispatch)
_DIGEST_SIZE = 8


def _chain_digest(parent, tokens):
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    h.update(parent)
    for tok in tokens:
        h.update(struct.pack("<q", int(tok)))
    return h.digest()


def prefix_fingerprint(prompt, block_tokens=16, max_blocks=4):
    """The hex digest of the leading full blocks of ``prompt`` (at most
    ``max_blocks``: system prompts dominate sharing, and the whole
    prompt would make every fingerprint unique), or None when the prompt
    holds no complete block."""
    if block_tokens < 1:
        raise ValueError("block_tokens must be >= 1")
    toks = list(prompt)
    full = len(toks) // block_tokens
    if full < 1:
        return None
    digest = _ROOT_DIGEST
    for i in range(min(full, max_blocks)):
        digest = _chain_digest(
            digest, toks[i * block_tokens:(i + 1) * block_tokens])
    return digest.hex()


def _ring_point(data):
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class HashRing(object):
    """Deterministic consistent-hash ring with `vnodes` virtual nodes a
    node: every process that builds it from the same nodes computes the
    same mapping."""

    def __init__(self, nodes=(), vnodes=64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self._vnodes = int(vnodes)
        self._points = []  # sorted [(point, node)]
        self._nodes = set()
        for node in nodes:
            self.add(node)

    def __len__(self):
        return len(self._nodes)

    def __contains__(self, node):
        return node in self._nodes

    def nodes(self):
        return sorted(self._nodes)

    def add(self, node):
        node = str(node)
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self._vnodes):
            point = _ring_point(("%s#%d" % (node, v)).encode("utf-8"))
            bisect.insort(self._points, (point, node))

    def remove(self, node):
        node = str(node)
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._points = [p for p in self._points if p[1] != node]

    def _start(self, key):
        point = _ring_point(str(key).encode("utf-8"))
        return bisect.bisect_right(self._points, (point, chr(0x10FFFF)))

    def lookup(self, key):
        """The node owning ``key``, or None on an empty ring."""
        if not self._points:
            return None
        return self._points[self._start(key) % len(self._points)][1]

    def successors(self, key):
        """Every distinct node in ring order from ``key``'s owner."""
        if not self._points:
            return []
        idx = self._start(key)
        out, seen = [], set()
        n = len(self._points)
        for off in range(n):
            node = self._points[(idx + off) % n][1]
            if node not in seen:
                seen.add(node)
                out.append(node)
        return out


class AffinityIndex(object):
    """TTL'd LRU mapping a prefix fingerprint to a replica address:
    entries expire after ``ttl_secs``, the table holds at most
    ``capacity`` (least recently used evicted first), and
    ``forget_address`` drops every entry of a retired replica."""

    def __init__(self, ttl_secs=60.0, capacity=4096):
        self._ttl = float(ttl_secs)
        self._cap = int(capacity)
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # fp -> (address, learned_at)

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def learn(self, fingerprint, address, now):
        if fingerprint is None:
            return
        with self._lock:
            self._entries.pop(fingerprint, None)
            self._entries[fingerprint] = (str(address), float(now))
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)

    def lookup(self, fingerprint, now):
        """The learned address, or None when unknown or stale."""
        if fingerprint is None:
            return None
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is None:
                return None
            address, learned_at = entry
            if now - learned_at > self._ttl:
                del self._entries[fingerprint]
                return None
            self._entries.move_to_end(fingerprint)
            return address

    def forget_address(self, address):
        address = str(address)
        with self._lock:
            stale = [fp for fp, (addr, _) in self._entries.items()
                     if addr == address]
            for fp in stale:
                del self._entries[fp]
            return len(stale)
