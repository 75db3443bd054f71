"""Radix prefix cache: cross-request KV reuse for the serving scheduler —
the port of the JAX package's runtime/prefix_cache.py.

Production chat and RAG traffic is dominated by shared prefixes (system
prompts, few-shot templates, multi-turn history); without this cache every
admission recomputes its whole prompt. In the style of SGLang's
RadixAttention (Zheng et al., 2024) over vLLM-shaped blocks (Kwon et al.,
SOSP '23):

  * a RADIX INDEX over token prefixes at fixed block granularity: each edge
    is exactly one ``block_len``-token block (edges never split; a lookup
    is a dict walk), keyed by the block's token ids, holding an arena
    block id;
  * a REFERENCE-COUNTED BLOCK POOL carved from a dedicated
    ``(num_blocks, layers, kv_heads, block_len, head_size)`` K/V arena
    (``Engine.new_prefix_arena``) with LRU eviction of UNREFERENCED LEAVES:
    eviction never frees a block a pinned (in-flight) path references, and
    evicting leaves only keeps the tree prefix-closed;
  * scheduler integration (runtime/scheduler.py): at admission the longest
    cached prefix seeds the slot's cache row (``Engine.slot_seed_prefix``)
    and only the suffix prefills; when a slot's prompt finishes prefilling,
    its PROMPT K/V is published back in blocks
    (``Engine.slot_publish_block``). Prefill-written blocks only: decode-step
    K/V is not guaranteed bitwise-equal to a cold prefill's.

Invariants:

  * EXACT-TOKEN-MATCH ONLY: K/V holds post-RoPE keys at absolute positions,
    so a block is valid only as the same tokens at the same positions, which
    a prefix walk guarantees by construction.
  * BLOCKS ARE IMMUTABLE ONCE PUBLISHED: publish copies cache -> arena, seed
    copies arena -> cache; a second publish of a prefix walks the existing
    nodes and copies nothing.
  * A LOOKUP NEVER COVERS THE WHOLE PROMPT: at least one suffix token
    prefills, so the finishing chunk has real logits to sample.
  * THE ARENA DIES WITH THE ENGINE: ``invalidate()`` drops the whole tree;
    the scheduler calls it on abort, and a supervisor rebuild mints a fresh
    engine, arena and tree (runtime/resilience.py).

The cross-replica transfer half of the JAX module (``export_pin``,
``export_block_host``, ``import_path``, ``transfer=True``) belongs to the
fleet, ROADMAP item 16, and is not ported.

Thread model: every method runs in the scheduler's step under its mutex,
except ``match_len`` (a read-only peek); the counters in ``stats`` are plain
ints a /stats reader snapshots lock-free under the GIL.
"""

from __future__ import annotations

import heapq

from .stats import PrefixCacheStats


class _Node:
    """One radix edge and node: ``key`` is the block's token tuple,
    ``block`` the arena block holding its K/V, ``refs`` the in-flight
    slots pinned through it, ``last_use`` the LRU clock stamp, ``epoch``
    the invalidate() generation it belongs to."""

    __slots__ = ("key", "block", "parent", "children", "refs", "last_use",
                 "epoch")

    def __init__(self, key, block, parent, epoch=0):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict = {}
        self.refs = 0
        self.last_use = 0
        # a detached depth >= 2 node still hangs off its (equally
        # detached) parent, so the attachment check alone cannot tell it
        # from a live node; the epoch can
        self.epoch = epoch


class PrefixCache:
    def __init__(self, engine, *, num_blocks: int, block_len: int,
                 transfer: bool = False):
        if transfer:
            raise ValueError("transfer=True is not ported yet: the KV "
                             "transfer plane comes with the fleet (ROADMAP "
                             "item 16)")
        if num_blocks < 1 or not 1 <= block_len <= engine.seq_len:
            raise ValueError(f"prefix cache of {num_blocks} blocks of "
                             f"{block_len} tokens (context {engine.seq_len})")
        self.engine = engine
        self.block_len = int(block_len)
        self.num_blocks = int(num_blocks)
        # the most blocks a seed or a publish covers
        self.max_seed_blocks = max(engine.seq_len // self.block_len, 1)
        self.arena_k, self.arena_v = engine.new_prefix_arena(
            self.num_blocks, self.block_len)
        self._root = _Node(None, -1, None)  # sentinel: never evicted
        self._free = list(range(self.num_blocks))
        # LRU eviction candidates: a LAZY min-heap of (last_use at push,
        # seq, node); an entry goes stale when its node is re-touched,
        # pinned, extended or detached, and _evict_lru_leaf discards it on
        # pop, so each candidate transition is an O(log n) push
        self._heap: list = []
        self._seq = 0
        self._tick = 0
        self._epoch = 0
        self.stats = PrefixCacheStats()
        self.stats.num_blocks = self.num_blocks
        self.stats.block_len = self.block_len

    def release(self) -> None:
        """Give the arena back to the allocator (a supervisor rebuild, on
        the failed generation's cache before its factory allocates the
        next engine; the scheduler's abort has invalidated the tree). The
        cache is unusable afterwards."""
        self.arena_k = self.arena_v = None

    # -- lookup / seed ------------------------------------------------------

    def _walk(self, tokens: list[int], max_blocks: int) -> list[_Node]:
        """Longest cached prefix of `tokens` in whole blocks (a partial
        block is never indexed), capped at `max_blocks`."""
        bl = self.block_len
        path: list[_Node] = []
        node = self._root
        for i in range(min(len(tokens) // bl, max_blocks)):
            child = node.children.get(tuple(tokens[i * bl: (i + 1) * bl]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def match_len(self, tokens: list[int]) -> int:
        """Read-only peek at the longest usable cached prefix (the rule of
        lookup_pin): no pin, no LRU touch, no stats. Safe outside the step
        mutex: the walk only reads children dicts, so a concurrent publish
        or eviction can make the answer stale, never wrong in kind."""
        usable = max(len(tokens) - 1, 0) // self.block_len
        return len(self._walk(tokens, usable)) * self.block_len

    def lookup_pin(self, tokens: list[int]):
        """Longest cached prefix usable for `tokens`: (n_tokens, block_ids,
        pins). The matched path is PINNED until the caller unpins, so an
        in-flight slot's blocks are never evicted under it. Capped at
        len(tokens) - 1: at least one suffix token prefills."""
        self._tick += 1
        self.stats.lookups += 1
        usable = max(len(tokens) - 1, 0) // self.block_len
        path = self._walk(tokens, usable)
        if not path:
            return 0, [], ()
        for node in path:
            node.refs += 1
            node.last_use = self._tick
        self.stats.hits += 1
        n = len(path) * self.block_len
        self.stats.tokens_saved += n
        return n, [node.block for node in path], tuple(path)

    def seed_slot(self, row: int, block_ids: list[int]) -> None:
        """Seed slot `row` from `block_ids` (their K/V into the row's
        leading positions)."""
        self.engine.slot_seed_prefix(self.arena_k, self.arena_v, row,
                                     block_ids)

    def unpin(self, pins) -> None:
        """Release a lookup_pin path (slot retired or aborted). Tolerates
        nodes an invalidate() already detached: their counters are
        orphaned bookkeeping, never a double free (invalidate rebuilds the
        free list wholesale)."""
        for node in pins:
            node.refs = max(node.refs - 1, 0)
            self._push_candidate(node)  # may just have become evictable

    # -- publish --------------------------------------------------------------

    def publish(self, row: int, tokens: list[int]) -> None:
        """Index slot `row`'s filled K/V under `tokens`, whole blocks only.
        Existing nodes are walked for free (republishing a shared prefix
        copies nothing); only NEW blocks are copied out of the cache row
        into freshly allocated arena blocks. Stops at the first block the
        pool cannot serve (publish_drops): dropping the TAIL keeps the tree
        prefix-closed.

        The new blocks follow the last existing node, so they cover
        consecutive positions: all are allocated first, copied in ONE
        engine call (a copy a layer, not a layer a block), then attached.
        While allocating, the walk path is PINNED and the new blocks are
        not in the tree yet, so an eviction never takes a block this
        publish stands on or fills."""
        self._tick += 1
        bl = self.block_len
        n_blocks = min(len(tokens) // bl, self.max_seed_blocks)
        node = self._root
        path: list[_Node] = []
        try:
            i = 0
            while i < n_blocks:
                child = node.children.get(tuple(tokens[i * bl: (i + 1) * bl]))
                if child is None:
                    break
                child.refs += 1
                child.last_use = self._tick
                path.append(child)
                node = child
                i += 1
            new: list[int] = []
            for _ in range(i, n_blocks):
                block = self._alloc()
                if block is None:
                    self.stats.publish_drops += 1
                    break
                new.append(block)
            if new:
                self.engine.slot_publish_block(self.arena_k, self.arena_v, row,
                                               i * bl, new)
            for j, block in enumerate(new, start=i):
                key = tuple(tokens[j * bl: (j + 1) * bl])
                child = _Node(key, block, node, epoch=self._epoch)
                node.children[key] = child
                self.stats.blocks_published += 1
                self.stats.blocks_in_use += 1
                child.refs += 1
                child.last_use = self._tick
                path.append(child)
                node = child
        finally:
            for n in path:
                n.refs = max(n.refs - 1, 0)
            if path:
                self._push_candidate(path[-1])  # the walk's deepest leaf

    # -- the pool -------------------------------------------------------------

    def _alloc(self) -> int | None:
        if self._free:
            return self._free.pop()
        return self._evict_lru_leaf()

    def _entry_valid(self, last_use: int, node: _Node) -> bool:
        """Does a heap entry still describe reality? Stale when the node
        was re-touched, pinned, extended into an interior node, detached,
        or belongs to an earlier epoch (returning such a node's block would
        hand out a block the rebuilt free list already owns)."""
        return (node.epoch == self._epoch
                and node.refs == 0 and not node.children
                and node.parent is not None
                and node.parent.children.get(node.key) is node
                and node.last_use == last_use)

    def _push_candidate(self, node: _Node) -> None:
        """Record `node` as a possible eviction victim if it is an attached,
        unreferenced leaf now; pop time re-checks (lazy invalidation)."""
        if (node.refs == 0 and not node.children
                and self._entry_valid(node.last_use, node)):
            self._seq += 1
            heapq.heappush(self._heap, (node.last_use, self._seq, node))
            if len(self._heap) > max(4 * self.num_blocks, 64):
                # compaction: with an ample pool no eviction pops the stale
                # entries, so the heap would grow one entry a request; valid
                # candidates are bounded by the leaves, so filtering back
                # down is amortized over the pushes that grew it
                seen: set = set()
                kept = []
                for entry in self._heap:
                    lu, _, n = entry
                    if self._entry_valid(lu, n) and id(n) not in seen:
                        seen.add(id(n))
                        kept.append(entry)
                self._heap = kept
                heapq.heapify(self._heap)

    def _evict_lru_leaf(self) -> int | None:
        """Free the least-recently-used UNREFERENCED LEAF's block (leaves
        only: an interior block never vanishes from under its descendants;
        pinned paths and the publishing walk are never candidates)."""
        while self._heap:
            last_use, _, node = heapq.heappop(self._heap)
            if not self._entry_valid(last_use, node):
                continue  # stale entry
            del node.parent.children[node.key]
            self.stats.evictions += 1
            self.stats.blocks_in_use -= 1
            # the eviction may have exposed its parent as a new leaf
            self._push_candidate(node.parent)
            return node.block
        return None  # everything is pinned or interior: the caller drops

    # -- lifecycle ------------------------------------------------------------

    def invalidate(self) -> None:
        """Drop the whole tree and reclaim every block: the engine
        generation the arena belongs to is being discarded (scheduler
        abort, supervisor rebuild, close), and a recovered engine must
        never seed from a dead engine's blocks. In-flight pins reference
        detached nodes, which unpin() tolerates."""
        self._root.children.clear()
        self._free = list(range(self.num_blocks))
        self._heap.clear()
        # detached survivors (a pinned deep node whose late unpin()
        # re-enqueues it) can never pass the validity check again
        self._epoch += 1
        self.stats.blocks_in_use = 0
        self.stats.invalidations += 1

    def warmup(self) -> None:
        """Run one seed and one publish off the serving clock, eagerly
        (there is nothing to capture), state-neutrally: the seed writes
        block 0's bytes into row 0 of an idle scheduler (overwritten by the
        row's next lease before any query attends them) and the publish
        targets a block still on the free list (overwritten by its first
        real allocation before any node references it). On a full pool
        every block backs a live node, so the publish is skipped."""
        self.seed_slot(0, [0])
        if self._free:
            self.engine.slot_publish_block(self.arena_k, self.arena_v, 0, 0,
                                           [self._free[-1]])
