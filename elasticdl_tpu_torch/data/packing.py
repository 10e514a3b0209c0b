"""Sequence packing for LM training: the port's copy of
elasticdl_tpu/data/packing.py.

Variable-length token sequences fill fixed-length rows instead of each
being padded to the model length. The model confines attention to each
packed run through `segment_ids` (the flash kernels' segment masks) and
restarts positions per run (ops/attention.packed_positions); the labels
here mask cross-segment next-token targets with ``IGNORE_LABEL``, so a
document never predicts the first token of the next one. The layout is
the JAX package's, row for row, for the same input order.
"""

import numpy as np

from elasticdl_tpu_torch.data.dataset import Dataset

# target value the LM loss ignores (model_zoo/transformer_lm.loss
# averages over labels >= 0 only)
IGNORE_LABEL = -100


def pack_sequences(sequences, row_len, pad_id=0):
    """Greedy first-fit-decreasing packing.

    sequences: iterable of 1-D int arrays/lists (token ids, each len
    >= 2 — a sequence contributes len-1 next-token targets).
    row_len: packed row length (the model seq_len).

    Returns (tokens, segment_ids, labels), each [n_rows, row_len] int32:
      * tokens      — packed ids, pad_id in the tail slack
      * segment_ids — 0..k per row, one id per packed sequence; the pad
                      tail gets its own fresh id (it attends only to
                      itself and its labels are ignored)
      * labels      — tokens shifted left WITHIN each segment; the last
                      position of every segment and all pad positions
                      are IGNORE_LABEL.

    Sequences longer than row_len are split into row_len-sized chunks
    (the standard LM blocking); a trailing chunk of length < 2 is
    dropped (it would carry no target).
    """
    chunks = []
    for seq in sequences:
        seq = np.asarray(seq, np.int32).reshape(-1)
        for start in range(0, len(seq), row_len):
            chunk = seq[start:start + row_len]
            if len(chunk) >= 2:
                chunks.append(chunk)
    if not chunks:
        raise ValueError("no packable sequences (all shorter than 2)")
    # first-fit-decreasing: longest chunks first, into the first row
    # with enough slack
    chunks.sort(key=len, reverse=True)
    rows = []  # list of lists of chunks
    slack = []
    for chunk in chunks:
        for i, s in enumerate(slack):
            if len(chunk) <= s:
                rows[i].append(chunk)
                slack[i] -= len(chunk)
                break
        else:
            rows.append([chunk])
            slack.append(row_len - len(chunk))

    n = len(rows)
    tokens = np.full((n, row_len), pad_id, np.int32)
    segment_ids = np.zeros((n, row_len), np.int32)
    labels = np.full((n, row_len), IGNORE_LABEL, np.int32)
    for r, row_chunks in enumerate(rows):
        tokens[r], segment_ids[r], labels[r] = _layout_row(
            row_chunks, row_len, pad_id
        )
    return tokens, segment_ids, labels


def _layout_row(row_chunks, row_len, pad_id):
    """One packed row from its list of chunks: (tokens, segment_ids,
    labels), each 1-D [row_len] int32. Next-token targets stay within
    each segment (the last position of a segment has no in-segment
    successor); the pad tail gets its own fresh segment id and ignored
    labels."""
    tokens = np.full(row_len, pad_id, np.int32)
    segment_ids = np.zeros(row_len, np.int32)
    labels = np.full(row_len, IGNORE_LABEL, np.int32)
    at = 0
    for sid, chunk in enumerate(row_chunks):
        m = len(chunk)
        tokens[at:at + m] = chunk
        segment_ids[at:at + m] = sid
        labels[at:at + m - 1] = chunk[1:]
        at += m
    if at < row_len:
        segment_ids[at:] = len(row_chunks)
    return tokens, segment_ids, labels


def pack_dataset(dataset, row_len, pad_id=0, open_rows=8):
    """Streaming packer over a host Dataset pipeline.

    dataset: a port `data.dataset.Dataset` (or any iterable) of 1-D int
    token sequences of VARIABLE length (e.g. the per-record output of
    a tokenizing `map`). Returns a new Dataset of packed LM examples
    `({"tokens": [row_len], "segment_ids": [row_len]}, labels)` —
    `.batch(n)` stacks them into model-ready packed batches, so a zoo
    ``dataset_fn`` can pack inside the worker's task stream instead of
    offline.

    First-fit over up to `open_rows` partially-filled rows: a row is
    emitted as soon as its slack cannot hold another target (< 2
    tokens), when room must be made, or at stream end — bounded memory,
    single pass, deterministic for a given input order."""
    def gen():
        rows = []   # open rows: lists of chunks
        slack = []  # remaining capacity per open row

        def emit(i):
            tokens, segment_ids, labels = _layout_row(
                rows.pop(i), row_len, pad_id
            )
            slack.pop(i)
            return (
                {"tokens": tokens, "segment_ids": segment_ids},
                labels,
            )

        for seq in dataset:
            seq = np.asarray(seq, np.int32).reshape(-1)
            for start in range(0, len(seq), row_len):
                chunk = seq[start:start + row_len]
                if len(chunk) < 2:
                    continue
                for i, s in enumerate(slack):
                    if len(chunk) <= s:
                        rows[i].append(chunk)
                        slack[i] -= len(chunk)
                        if slack[i] < 2:
                            yield emit(i)
                        break
                else:
                    if len(rows) >= open_rows:
                        # make room: emit the fullest open row
                        yield emit(int(np.argmin(slack)))
                    rows.append([chunk])
                    slack.append(row_len - len(chunk))
                    if slack[-1] < 2:
                        yield emit(len(rows) - 1)
        while rows:
            yield emit(0)

    return Dataset(gen)


def packing_efficiency(sequences, row_len):
    """Real-token fraction of the packed layout — the measure of what
    packing buys on a given corpus (1.0 = rows fully filled with real
    tokens). A segment of m tokens carries m-1 targets, so real tokens
    per segment = its non-ignored labels + 1; pad segments carry no
    targets and count 0."""
    tokens, segment_ids, labels = pack_sequences(sequences, row_len)
    real = 0
    for r in range(tokens.shape[0]):
        for sid in np.unique(segment_ids[r]):
            targets = int(
                (labels[r][segment_ids[r] == sid] != IGNORE_LABEL).sum()
            )
            if targets:
                real += targets + 1
    return real / tokens.size
