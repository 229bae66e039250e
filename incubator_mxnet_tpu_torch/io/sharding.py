"""Record and batch shard assignment (twin of
``incubator_mxnet_tpu/io/sharding.py``), used by ``ImageRecordIter``
(``num_parts``/``part_index``) and, with ROADMAP item A10's
``data_service``, by the multi-process data service.

Two partition shapes, both covering everything exactly once (the
union is everything, the parts are pairwise disjoint):

- :func:`shard_range` / :func:`shard_keys` — *contiguous* record
  partition for distributed readers (ref:
  src/io/iter_image_recordio_2.cc partition logic: part ``k`` of
  ``P`` reads records ``[floor(kN/P), floor((k+1)N/P))``).  Cutting
  on record boundaries via the ``.idx`` keys means no part ever
  starts mid-record, and the floor arithmetic makes the edges exact
  for every ``N``/``P`` (the naive ``N//P * k`` chunking drops up to
  ``P-1`` tail records).
- :func:`assigned_batches` — *round-robin batch* assignment for the
  data service's decode workers: worker ``w`` of ``W`` owns global
  batch indices ``w, w+W, w+2W, ...``, so a round-robin merge over
  workers reconstructs the exact single-process batch order (the
  determinism contract of ``DataServiceIter``).
"""

__all__ = ["shard_range", "shard_keys", "assigned_batches",
           "reshard_batch_cursors"]


def shard_range(n, num_parts, part_index):
    """Half-open record range ``[start, stop)`` owned by
    ``part_index`` of ``num_parts`` over ``n`` records.

    Floor arithmetic: ``start = n*k // P``.  Adjacent parts share an
    edge (``stop(k) == start(k+1)``), part 0 starts at 0 and the last
    part stops at ``n``, so coverage is exact for any ``n`` —
    including ``n < num_parts`` (some parts are empty, none overlap).
    """
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    if not 0 <= part_index < num_parts:
        raise ValueError(
            f"part_index {part_index} out of range for "
            f"{num_parts} part(s)")
    return (n * part_index // num_parts,
            n * (part_index + 1) // num_parts)


def shard_keys(keys, num_parts, part_index):
    """The contiguous slice of ``keys`` owned by ``part_index``."""
    start, stop = shard_range(len(keys), num_parts, part_index)
    return keys[start:stop]


def assigned_batches(num_batches, num_shards, shard):
    """Global batch indices owned by ``shard`` of ``num_shards``:
    ``shard, shard+num_shards, ...`` below ``num_batches``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0 <= shard < num_shards:
        raise ValueError(
            f"shard {shard} out of range for {num_shards} shard(s)")
    return list(range(shard, num_batches, num_shards))


def reshard_batch_cursors(num_batches, next_batch, num_shards):
    """Re-express a global round-robin stream position under a new
    shard count (the data-plane half of elastic restart,
    docs/elastic.md): the merged stream delivers global batches in
    order, so its exact position is ONE number — ``next_batch``, the
    next global batch index — and any shard count can re-derive its
    per-shard cursors from it.

    Returns ``(delivered, done)`` lists of length ``num_shards``:
    ``delivered[w]`` counts the batches of shard ``w``'s assignment
    (:func:`assigned_batches`) that lie before ``next_batch``, and
    ``done[w]`` is True when nothing of the assignment remains.  The
    union of remaining per-shard assignments is exactly the global
    range ``[next_batch, num_batches)``, each batch exactly once —
    the same exactly-once contract as the forward partition.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if next_batch < 0:
        raise ValueError(f"next_batch must be >= 0, got {next_batch}")
    g = min(int(next_batch), int(num_batches))
    delivered, done = [], []
    for w in range(num_shards):
        d = 0 if g <= w else (g - 1 - w) // num_shards + 1
        delivered.append(d)
        done.append(w + d * num_shards >= num_batches)
    return delivered, done
