"""Paged block allocator for the serving cache (counterpart of
``repro/serve/paged.py``, the attention family).

Slot-static serving reserves ``max_len`` cache tokens per batch slot
whether a request uses 8 of them or 500, and stores a shared system prompt
once per slot.  This module sizes cache memory in *tokens* instead: a
global pool of fixed-size pages, per-request page tables, refcounted
prefix sharing, and the gather/scatter around the unchanged
``model.prefill_chunk``.

Leaves split by their axes (``model.cache_axes()``): a leaf with a
``kv_seq`` axis of length ``max_len`` (K, V, pos, and the int8 cache's
scales) is paged; any other leaf is state (recurrent state, sliding-window
rings) that the reference keeps slot-resident and shares through snapshot
slots.  No ported family has one: a state leaf raises (ROADMAP A7).

Storage.  Per leaf name, one contiguous pool tensor of
``(n_pages + 1, layers, page_size, ...)``, built from the model's own
``init_cache(1, page_size)`` (every storage format the model allocates
pages identically).  Page 0 is the reserved *zero page* (the template:
unallocated logical pages point at it, so a gathered tail reads pos = -1
and zeros).  The last page, ``n_pages``, is a *sink*: the padding entries
of a step's fresh list and write triples point at it, in place of the
reference's out-of-range indices that ``mode="drop"`` discards, so no
index ever leaves the tensor on the card; nothing reads the sink.

The step (``step``), as the reference's ``make_step`` and
``make_spec_step``:

  1. reset freshly allocated pages to the template (a recycled page
     carries the previous owner's ``pos`` values),
  2. gather each row's pages, in logical order, into a persistent view of
     ``(layers, B, max_len + 1, ...)`` per leaf name, whose ``[l, :, :max_len]``
     slices are the per-layer cache ``prefill_chunk`` takes; slot max_len
     is the spare slot the step's dead columns write (``layers.ragged``),
  3. run ``prefill_chunk``, or a speculative round, on that view,
  4. scatter back only the pages inside each row's write window.

The gather covers the pages below the step's kv bucket (``kv_len``,
rounded up to whole pages) instead of all ``max_len``: attention reads no
key at or past ``kv_len``, and every page of a write window lies below it,
so the pool ends as the full gather leaves it.  Columns of the view past
the gathered pages hold stale values of earlier steps; they are masked
(the CPU's plain attention gives them probability 0 exactly, the kernel
does not read them).  Gather and scatter each run once per leaf name for
all layers: a handful of kernels a step, with fixed shapes per (C, kv, F,
M) bucket, so the step can be captured as a CUDA graph.

Shared prefix pages are never inside a write window (sharing is
page-aligned and a request's writes start after its shared prefix), so
copy-on-write reduces to share-read-only and allocate-fresh-for-writes.

Host-side accounting (``PagePool``, ``PrefixIndex``, the page tables) is
plain numpy / Python with the reference's free-list order, so the same
schedule gives the same page ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side page accounting.
# ---------------------------------------------------------------------------


class PagePool:
    """Free list + per-page refcounts.

    Page 0 is the reserved *zero page* (pristine template content): page
    tables point unallocated logical pages at it.  It is never allocated
    or freed.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("page pool needs >= 2 pages (page 0 is the "
                             "reserved zero page)")
        self.n_pages = n_pages
        self.ref = np.zeros((n_pages,), np.int32)
        self._free = list(range(n_pages - 1, 0, -1))   # LIFO, page 0 reserved

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int | None:
        """Pop a free page with refcount 1, or None if the pool is dry."""
        if not self._free:
            return None
        p = self._free.pop()
        assert self.ref[p] == 0, f"free list held referenced page {p}"
        self.ref[p] = 1
        return p

    def ref_inc(self, p: int):
        assert p != 0 and self.ref[p] > 0, f"ref_inc of unowned page {p}"
        self.ref[p] += 1

    def deref(self, p: int):
        assert p != 0, "deref of the reserved zero page"
        assert self.ref[p] > 0, f"double free of page {p}"
        self.ref[p] -= 1
        if self.ref[p] == 0:
            self._free.append(p)


@dataclasses.dataclass
class PrefixEntry:
    length: int            # tokens covered (page-aligned)
    pages: list            # physical pages holding the prefix
    last_use: int          # LRU clock


class PrefixIndex:
    """token-tuple-keyed prefix cache: exact (collision-free) chain keys."""

    def __init__(self):
        self.entries: dict[tuple, PrefixEntry] = {}
        self._clock = 0

    def tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, tokens: list[int], page_size: int,
               max_tokens: int) -> PrefixEntry | None:
        """Longest registered page-aligned prefix of ``tokens`` covering at
        most ``max_tokens``."""
        j = min(len(tokens), max_tokens) // page_size
        while j > 0:
            e = self.entries.get(tuple(tokens[: j * page_size]))
            if e is not None:
                e.last_use = self.tick()
                return e
            j -= 1
        return None


# ---------------------------------------------------------------------------
# Device-side paged cache.
# ---------------------------------------------------------------------------


class PagedCache:
    """Pool storage, the view and the paged step; page tables and the
    prefix index.

    The engine owns policy (scheduling, preemption victims, admission);
    this class owns mechanics.
    """

    def __init__(self, model, slots: int, max_len: int, page_size: int,
                 n_pages: int, prefix_sharing: bool = True):
        if max_len % page_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        self.B = slots
        self.max_len = max_len
        self.ps = page_size
        self.n_pp = max_len // page_size
        self.sharing = prefix_sharing

        axes = model.cache_axes()
        paged_mask = []
        for layer, ax in zip(model.init_cache(1, max_len), axes):
            for name, leaf in layer.items():
                a = ax[name]
                s = a.index("kv_seq") if "kv_seq" in a else -1
                paged = s >= 0 and leaf.shape[s] == max_len
                if paged and (a.index("batch"), s) != (0, 1):
                    raise ValueError(f"paged leaf {name!r} needs its batch "
                                     "axis at 0 and kv_seq at 1")
                paged_mask.append(paged)
        if not paged_mask or not all(paged_mask):
            raise NotImplementedError(
                "cache leaves without a max_len kv_seq axis (recurrent state, "
                "sliding-window rings) stay slot-resident and share through "
                "snapshot slots: not ported yet (ROADMAP A7)")

        # per leaf name, one pool and one view for every layer
        tmpl = model.init_cache(1, page_size)
        names = list(tmpl[0])
        self.L = len(tmpl)
        self.n_pages = n_pages
        self.pool: dict[str, torch.Tensor] = {}
        self._buf: dict[str, torch.Tensor] = {}
        self._fill: dict[str, float | int] = {}
        for name in names:
            pages = [layer[name] for layer in tmpl]
            t = pages[0]
            fill = t.flatten()[0]
            if any(list(layer) != names for layer in tmpl) or any(
                    p.shape != t.shape or p.dtype != t.dtype
                    or not bool((p == fill).all()) for p in pages):
                raise ValueError(f"cache leaf {name!r}: the page pool needs "
                                 "one shape, dtype and constant template "
                                 "in every layer")
            self._fill[name] = fill.item()
            rest = tuple(t.shape[2:])
            # page-major: a page of every layer is one contiguous block,
            # which index_select and index_copy_ move in long runs
            self.pool[name] = torch.full(
                (n_pages + 1, self.L, page_size, *rest), fill.item(),
                dtype=t.dtype, device=t.device)
            self._buf[name] = torch.full(
                (self.L, slots, max_len + 1, *rest), fill.item(),
                dtype=t.dtype, device=t.device)
        # the cache prefill_chunk takes: [:, :max_len] of each layer's rows,
        # the spare slot behind them
        self.view = [{name: self._buf[name][i, :, :max_len]
                      for name in names} for i in range(self.L)]

        self.pages = PagePool(n_pages)
        self.tables = np.zeros((slots, self.n_pp), np.int32)  # 0 = unallocated
        self.prefix = PrefixIndex()

    # -- the step ------------------------------------------------------------

    def gather_pages(self, kv_len: int) -> int:
        """Pages per row the step at kv bucket ``kv_len`` gathers."""
        return -(-kv_len // self.ps)

    def step(self, fn, table, fresh, rows, lps, phys):
        """reset fresh pages → gather → ``fn(view)`` → scatter the write
        windows; returns what ``fn`` returns.  ``fn`` runs on the view: a
        ``prefill_chunk`` (the reference's ``make_step``) or a speculative
        round (``make_spec_step``: its rollback rewinds the view, so the
        scatter of the whole k+1-token window writes rejected positions
        back with their pre-round bytes).  ``table``: (B·g,) page ids of
        each row's first g = ``gather_pages(kv_len)`` logical pages, kv_len
        the kv bucket ``fn`` attends to; ``fresh`` (F,): pages to reset;
        ``rows``, ``lps``, ``phys`` (M,): the (row, logical page) →
        physical page triples to write back.  Padding entries of ``fresh``
        and ``phys`` point at the sink page ``n_pages``.  Every index is a
        device tensor of fixed shape, and the step does no host work."""
        self.gather(table, fresh)
        out = fn(self.view)
        self.scatter(rows, lps, phys)
        return out

    def gather(self, table, fresh) -> None:
        """Reset the ``fresh`` pages to the template, then copy each row's
        first g = ``len(table) / B`` pages into the view: one index_fill,
        one index_select and one copy (layer axis to the front) a leaf name,
        for every layer."""
        g = table.shape[0] // self.B
        for name, pool in self.pool.items():
            pool.index_fill_(0, fresh, self._fill[name])
            rows_g = pool.index_select(0, table).view(
                self.B, g, self.L, self.ps, *pool.shape[3:])
            self._buf[name][:, :, :g * self.ps].unflatten(
                2, (g, self.ps)).copy_(rows_g.movedim(2, 0))

    def scatter(self, rows, lps, phys) -> None:
        """Write the view's (row, logical page) pages back to their physical
        pages, every layer at once (padding triples write the sink)."""
        for pool, buf in zip(self.pool.values(), self._buf.values()):
            pages = buf[:, :, :self.max_len].unflatten(2, (self.n_pp, self.ps))
            pool.index_copy_(0, phys, pages.movedim(0, 2)[rows, lps])

    # -- host-side bookkeeping ----------------------------------------------

    def free_slot(self, b: int):
        """Release every page slot b's table references (shared prefix pages
        survive through their index entries' refcounts)."""
        self.free_beyond(b, 0)

    def slot_pages(self, b: int) -> int:
        return int(np.count_nonzero(self.tables[b]))

    def plan_writes(self, b: int, pos: int, n: int):
        """Allocate pages covering row b's write window [pos, pos+n).

        Returns ``(fresh, triples)`` — fresh page ids to reset and
        (row, lp, phys) scatter triples — or None if the pool ran dry
        (allocations made so far are rolled back; the engine evicts or
        preempts and retries)."""
        if n <= 0:
            return [], []
        lp0, lp1 = pos // self.ps, (pos + n - 1) // self.ps
        fresh, triples = [], []
        for lp in range(lp0, lp1 + 1):
            p = int(self.tables[b, lp])
            if p == 0:
                p = self.pages.alloc()
                if p is None:
                    for fp in fresh:           # roll back this plan
                        self.pages.deref(fp)
                        self.tables[b, np.where(self.tables[b] == fp)[0]] = 0
                    return None
                self.tables[b, lp] = p
                fresh.append(p)
            triples.append((b, lp, p))
        return fresh, triples

    def max_take(self, b: int, pos: int) -> int:
        """Largest n for which ``plan_writes(b, pos, n)`` would succeed
        right now (existing pages + free pool)."""
        take = 0
        budget = self.pages.n_free
        lp = pos // self.ps
        off = pos
        while lp < self.n_pp:
            if int(self.tables[b, lp]) == 0:
                if budget == 0:
                    break
                budget -= 1
            take += (lp + 1) * self.ps - off
            off = (lp + 1) * self.ps
            lp += 1
        return take

    def free_beyond(self, b: int, pos: int):
        """Release row b's pages wholly at or past position ``pos`` (a
        speculative round's uncommitted window pages; 0: all of them)."""
        for lp in range((pos + self.ps - 1) // self.ps, self.n_pp):
            p = int(self.tables[b, lp])
            if p:
                self.pages.deref(p)
                self.tables[b, lp] = 0

    # -- prefix sharing -------------------------------------------------------

    def prefix_lookup(self, tokens: list[int]) -> PrefixEntry | None:
        if not self.sharing:
            return None
        # always leave ≥1 token to recompute: the sampler needs the last
        # prompt token's logits, which the prefix cache does not store
        return self.prefix.lookup(tokens, self.ps, len(tokens) - 1)

    def prefix_admit(self, b: int, entry: PrefixEntry):
        """Point slot b's table at a shared prefix.  The caller sets
        slot.pos = entry.length."""
        for lp, p in enumerate(entry.pages):
            assert int(self.tables[b, lp]) == 0
            self.pages.ref_inc(p)
            self.tables[b, lp] = p

    def register_prefix(self, b: int, tokens: list[int], length: int) -> bool:
        """Register slot b's first ``length`` (page-aligned) tokens: the
        entry holds a reference on each of their pages."""
        if not self.sharing or length <= 0 or length % self.ps:
            return False
        key = tuple(tokens[:length])
        if key in self.prefix.entries:
            return True
        pages = [int(self.tables[b, lp]) for lp in range(length // self.ps)]
        assert all(pages)
        for p in pages:
            self.pages.ref_inc(p)
        self.prefix.entries[key] = PrefixEntry(
            length=length, pages=pages, last_use=self.prefix.tick())
        return True

    def register_levels(self, b: int, tokens: list[int], length: int):
        """Register every page-aligned prefix level up to ``length``:
        entries share page references, so a later request matching any
        shared depth hits."""
        for j in range(1, length // self.ps + 1):
            self.register_prefix(b, tokens, j * self.ps)

    def evict_one(self, require_free: bool = False) -> bool:
        """Drop the least-recently-used prefix entry, releasing its page
        references; pages still referenced by a live request stay resident.

        ``require_free``: only evict an entry whose release returns at
        least one page to the free list, so page-pressure escalation
        cannot wipe a hot shared prefix without gaining memory."""
        order = sorted(self.prefix.entries,
                       key=lambda k: self.prefix.entries[k].last_use)
        for key in order:
            e = self.prefix.entries[key]
            if require_free and not any(
                    int(self.pages.ref[p]) == 1 for p in e.pages):
                continue
            self.prefix.entries.pop(key)
            for p in e.pages:
                self.pages.deref(p)
            return True
        return False

    # -- accounting / invariants ----------------------------------------------

    def nbytes(self) -> int:
        """Bytes of the page pool (the sink page included)."""
        return sum(t.numel() * t.element_size() for t in self.pool.values())

    def pool_tokens(self) -> int:
        return (self.n_pages - 1) * self.ps

    def occupancy(self) -> dict:
        """Pool residency: usable pages (the zero page is reserved), free
        pages, and the occupied fraction.  Host-side counters only."""
        usable = self.n_pages - 1
        free = self.pages.n_free
        return {"pages": usable, "pages_free": free,
                "occupancy": (usable - free) / usable if usable else 0.0}

    def audit(self):
        """Invariant check (tests call this after every mutation batch):
        per-page refcounts equal table references + prefix-entry
        references; the free list is exactly the unreferenced pages,
        duplicate-free; the zero page still holds the template."""
        refs = np.zeros((self.n_pages,), np.int32)
        for b in range(self.B):
            for lp in range(self.n_pp):
                p = int(self.tables[b, lp])
                if p:
                    refs[p] += 1
        for e in self.prefix.entries.values():
            for p in e.pages:
                refs[p] += 1
        assert refs[0] == 0, "zero page must never be referenced by tables"
        np.testing.assert_array_equal(refs, self.pages.ref)
        free = self.pages._free
        assert len(free) == len(set(free)), "duplicate pages in free list"
        assert 0 not in free, "zero page on the free list"
        expect_free = {p for p in range(1, self.n_pages) if refs[p] == 0}
        assert set(free) == expect_free, (set(free), expect_free)
        for name, pool in self.pool.items():
            assert bool((pool[0] == self._fill[name]).all()), (
                f"the zero page of {name!r} was written")
