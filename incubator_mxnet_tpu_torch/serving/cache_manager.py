"""Prefix cache: shared-prompt KV reuse over the block pool (twin of
``incubator_mxnet_tpu/serving/cache_manager.py``; pure host code).

Serving traffic is dominated by a few system prompts fanned out
across many requests.  Full blocks of prompt KV are content-
addressed by a rolling token hash, so a request whose prompt starts
with an already-served prefix adopts those blocks COPY-FREE — its
block table points at the cached ids (refcounted by
block_table.BlockPool) and prefill recomputes only the suffix.

Keying: block ``i`` of a token stream is identified by the hash
chain ``key_i = hash((key_{i-1},) + tokens[i*bs:(i+1)*bs])`` — O(1)
memory per entry, and a block only matches when its ENTIRE token
history matches (not just its own tokens).  Hash collisions are
possible in principle (64-bit Python hashes) but would need two
distinct token histories colliding on the same chain; acceptable for
a cache whose failure mode is visible wrong output under adversarial
prompts.

Matching stops at ``(len(tokens) - 1) // block_size`` full blocks:
the LAST prompt token is always left to the suffix so prefill has at
least one query row to emit first-token logits from.

Eviction is LRU over entries whose block's ONLY remaining holder is
the cache itself — a block still referenced by a running request is
never evicted (the entry just leaves the cache; the request keeps
its context).
"""
from collections import OrderedDict

__all__ = ["PrefixCache"]

_SEED = 0x5eed                      # chain seed, arbitrary non-zero


class PrefixCache:
    """Token-hash -> pool-block map with LRU eviction.

    Owns one refcount on every cached block (taken at
    :meth:`insert`, dropped at eviction), so cached KV survives the
    request that produced it until pool pressure reclaims it.
    """

    def __init__(self, pool, enabled=True):
        self._pool = pool
        self.enabled = bool(enabled)
        self._entries = OrderedDict()       # chain key -> block id

    def __len__(self):
        return len(self._entries)

    @staticmethod
    def _chain(key, block_tokens):
        return hash((key,) + tuple(block_tokens))

    def match(self, tokens):
        """Longest cached chain over the leading full blocks of
        ``tokens`` (at most ``(len-1)//bs`` — see module doc).

        Increfs every matched block (the caller's request becomes a
        holder) and returns ``(block_ids, n_cached_tokens)``."""
        if not self.enabled:
            return [], 0
        bs = self._pool.block_size
        matched = []
        key = _SEED
        for i in range((len(tokens) - 1) // bs):
            key = self._chain(key, tokens[i * bs:(i + 1) * bs])
            bid = self._entries.get(key)
            if bid is None:
                break
            self._entries.move_to_end(key)          # LRU touch
            matched.append(bid)
        if matched:
            self._pool.incref(matched)
        return matched, len(matched) * bs

    def insert(self, tokens, block_ids):
        """Register the full blocks of a just-prefilled token stream
        (``block_ids[i]`` holds positions ``[i*bs, (i+1)*bs)``).

        The cache increfs each NEWLY inserted block; blocks whose
        chain key is already cached (e.g. the matched prefix this
        request adopted) are only LRU-touched — a concurrent
        duplicate prefill keeps the first block registered.  Returns
        the number of new entries."""
        if not self.enabled:
            return 0
        bs = self._pool.block_size
        key = _SEED
        added = 0
        for i in range(len(tokens) // bs):
            key = self._chain(key, tokens[i * bs:(i + 1) * bs])
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            bid = block_ids[i]
            self._pool.incref([bid])
            self._entries[key] = bid
            added += 1
        return added

    def block_refs(self):
        """``{block_id: refs held by the cache}`` — the cache's side
        of the pool leak audit: after an engine drains, every live
        pool block's refcount must be exactly what this returns (the
        chaos and leak-audit tests assert the equality against
        ``BlockPool.live()``, so a terminal path that leaks a
        request's hold on a shared block is caught by id)."""
        refs = {}
        for bid in self._entries.values():
            refs[bid] = refs.get(bid, 0) + 1
        return refs

    def evict(self, n):
        """Free up to ``n`` cache-held blocks in LRU order, skipping
        any still shared with a live request.  Returns blocks
        actually freed."""
        if n <= 0:
            return 0
        freed = 0
        for key in list(self._entries):
            if freed >= n:
                break
            bid = self._entries[key]
            if self._pool.refcount(bid) == 1:       # cache-only
                del self._entries[key]
                self._pool.free([bid])
                freed += 1
        return freed

    def clear(self):
        """Drop every entry (releasing the cache's refs)."""
        for bid in self._entries.values():
            self._pool.free([bid])
        self._entries.clear()
