"""Fixed device-resident KV block pool + host-side allocator (twin of
``incubator_mxnet_tpu/serving/block_table.py``; pure host code).

The serving tier's memory model: instead of one
dense ``(max_len, ...)`` KV buffer per sequence, every layer owns ONE
pool array of shape ``(num_blocks, block_size, kv_heads, head_dim)``
and each running request holds an ordered list of block ids — its
*block table*.  A sequence of ``n`` tokens costs ``ceil(n /
block_size)`` blocks at its ACTUAL length, so thousands of mixed-
length sequences share HBM with at most ``block_size - 1`` wasted
slots each, and a shared prompt prefix is one set of block ids held
by many tables (prefix caching, cache_manager.py).

:class:`BlockPool` is the host-side allocator over that id space:
a free stack plus a per-block refcount.  Refcounting is what makes
prefix sharing copy-free — a block lives until its last holder
(request or prefix cache) releases it, and a double ``free`` raises
instead of silently corrupting another request's context.

Block id 0 is RESERVED as the scratch block: inactive batch slots
and padded prefill rows scatter their garbage writes there inside
the step, so the captured decode graph never needs a host-side
branch on slot liveness.  The allocator never hands out id 0.
"""

__all__ = ["BlockPool", "BlockPoolExhausted"]


class BlockPoolExhausted(RuntimeError):
    """No free blocks left in the pool.

    The scheduler answers this by evicting unreferenced prefix-cache
    blocks and, failing that, preempting the latest-admitted request
    (its blocks free, it re-queues) — see engine._grow."""


class BlockPool:
    """Allocator for a fixed pool of ``num_blocks`` KV blocks of
    ``block_size`` tokens each.  Block 0 is the reserved scratch
    block and is never allocated; capacity is ``num_blocks - 1``.

    All methods are host-side and O(blocks touched); the device pool
    arrays themselves live in the engine — this class only governs
    which ids are live and how many holders each has.
    """

    def __init__(self, num_blocks, block_size):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (got {num_blocks}): block "
                "0 is the reserved scratch block")
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1 (got {block_size})")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free stack: recently-freed blocks are re-used first
        # (their pool slots are warm in the card's cache)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}                    # live block id -> refcount

    # ------------------------------------------------------- queries
    @property
    def capacity(self):
        """Allocatable blocks (scratch block excluded)."""
        return self.num_blocks - 1

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_allocated(self):
        return self.capacity - len(self._free)

    def utilization(self):
        """Fraction of the allocatable pool currently live."""
        return self.num_allocated / self.capacity

    def refcount(self, block_id):
        """Current holders of ``block_id`` (0 when free)."""
        return self._ref.get(block_id, 0)

    def live(self):
        """Snapshot of live block refcounts ``{block_id: holders}``.

        The leak-audit view: after an engine drains, every live
        block must be accounted for by the prefix cache alone — the
        chaos/regression tests assert exactly that, so a terminal
        path (retire/evict/expire/cancel) that forgets to free shows
        up as a named block with a holder nobody owns."""
        return dict(self._ref)

    # ----------------------------------------------------- lifecycle
    def alloc(self, n=1):
        """Allocate ``n`` blocks at refcount 1; returns their ids.

        All-or-nothing: raises :class:`BlockPoolExhausted` (and
        allocates nothing) when fewer than ``n`` are free, so a
        failed admission never leaks a partial allocation."""
        if n < 0:
            raise ValueError(f"alloc(n={n})")
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"(pool capacity {self.capacity})")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block_ids):
        """Add a holder to each live block (prefix-cache hits and
        inserts).  Incref of a free block is always a bug."""
        for b in block_ids:
            if b not in self._ref:
                raise ValueError(
                    f"incref on free block {b}: a holder must exist "
                    "before it can be shared")
            self._ref[b] += 1

    def free(self, block_ids):
        """Drop one holder from each block; a block whose last
        holder leaves returns to the free stack.  Freeing an
        already-free block raises (double-free)."""
        for b in block_ids:
            r = self._ref.get(b)
            if r is None:
                raise ValueError(
                    f"double free of block {b} (already free)")
            if r == 1:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = r - 1

    def __repr__(self):
        return (f"BlockPool(blocks={self.num_blocks}, "
                f"block_size={self.block_size}, "
                f"free={self.num_free}/{self.capacity})")
