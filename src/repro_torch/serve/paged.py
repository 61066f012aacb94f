"""Paged block allocator for the serving cache (counterpart of
``repro/serve/paged.py``).

Slot-static serving reserves ``max_len`` cache tokens per batch slot
whether a request uses 8 of them or 500, and stores a shared system prompt
once per slot.  This module sizes cache memory in *tokens* instead: a
global pool of fixed-size pages, per-request page tables, refcounted
prefix sharing, and the gather/scatter around the unchanged
``model.prefill_chunk``.

Leaves split by their axes (``model.cache_axes()``), layer by layer, as
the reference splits them:

  * **paged leaves** — a ``kv_seq`` axis of length ``max_len`` (K, V, pos,
    the int8 cache's scales; a sliding-window ring when ``max_len <=
    window``, where it never wraps);
  * **state leaves** — every other one (an RG-LRU layer's ``conv`` and
    ``h``, a ring of ``window < max_len`` slots).  They stay slot-resident,
    one row a slot, and prefix sharing copies them into *snapshot slots*:
    a prefix entry owns a copy of the row's state at its boundary, restored
    on a hit (``snap_save``, ``snap_restore``); ``reset_slot`` resets a
    row to the template.  With no paged leaf at all the pool is nominal
    (two pages, nothing allocated).

Storage.  Per paged leaf name, one contiguous pool tensor of
``(n_pages + 1, layers, page_size, ...)`` over the layers that hold that
name as a paged leaf, built from the model's own ``init_cache(1,
page_size)`` (every storage format the model allocates pages identically).
Page 0 is the reserved *zero page* (the template: unallocated logical pages
point at it, so a gathered tail reads pos = -1 and zeros).  The last page,
``n_pages``, is a *sink*: the padding entries of a step's fresh list and
write triples point at it, in place of the reference's out-of-range
indices that ``mode="drop"`` discards, so no index ever leaves the tensor
on the card; nothing reads the sink.

The step (``step``), as the reference's ``make_step`` and
``make_spec_step``:

  1. reset freshly allocated pages to the template (a recycled page
     carries the previous owner's ``pos`` values),
  2. gather each row's pages, in logical order, into a persistent view of
     ``(layers, B, max_len + 1, ...)`` per leaf name, whose ``[l, :, :max_len]``
     slices, with the layer's state leaves, are the per-layer cache
     ``prefill_chunk`` takes (a ``LayerCaches`` of ``max_len``); slot
     max_len is the spare slot the step's dead columns write
     (``layers.ragged``),
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

from repro_torch.models.transformer import LayerCaches

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
    pages: list            # physical pages holding the prefix (paged leaves)
    snap: int | None       # snapshot slot holding the state leaves, if any
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


def _constant(name: str, leaves: list) -> float | int:
    """The one value every template leaf of ``name`` is filled with (a
    page or a state row is reset to it), checking one shape and dtype."""
    t = leaves[0]
    fill = t.flatten()[0]
    if any(x.shape != t.shape or x.dtype != t.dtype
           or not bool((x == fill).all()) for x in leaves):
        raise ValueError(f"cache leaf {name!r}: the paged cache needs one "
                         "shape, dtype and constant template in every "
                         "layer that holds it")
    return fill.item()


class PagedCache:
    """Pool storage, the slot-resident state leaves and their snapshot
    slots, the view and the paged step; page tables and the prefix index.

    The engine owns policy (scheduling, preemption victims, admission);
    this class owns mechanics.
    """

    def __init__(self, model, slots: int, max_len: int, page_size: int,
                 n_pages: int, snap_slots: int = 0,
                 prefix_sharing: bool = True):
        if max_len % page_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        self.B = slots
        self.max_len = max_len
        self.ps = page_size
        self.n_pp = max_len // page_size
        self.sharing = prefix_sharing

        # classify each (layer, leaf) by its axes, as the reference does
        probe = model.init_cache(1, max_len)
        self.names = [list(layer) for layer in probe]
        self.L = len(probe)
        self.layers: dict[str, list[int]] = {}   # paged name -> its layers
        static_keys = []                          # (layer, name) of state
        for i, (layer, ax) in enumerate(zip(probe, model.cache_axes())):
            for name, leaf in layer.items():
                a = ax[name]
                s = a.index("kv_seq") if "kv_seq" in a else -1
                if s >= 0 and leaf.shape[s] == max_len:
                    if (a.index("batch"), s) != (0, 1):
                        raise ValueError(f"paged leaf {name!r} needs its "
                                         "batch axis at 0 and kv_seq at 1")
                    self.layers.setdefault(name, []).append(i)
                else:
                    if a.index("batch") != 0:
                        raise ValueError(f"state leaf {name!r} needs its "
                                         "batch axis at 0")
                    static_keys.append((i, name))
        self.has_paged = bool(self.layers)
        self.has_state = bool(static_keys)

        # per paged leaf name, one pool and one view over the layers that
        # hold it
        tmpl = model.init_cache(1, page_size)
        self.n_pages = n_pages if self.has_paged else 2
        self.pool: dict[str, torch.Tensor] = {}
        self._buf: dict[str, torch.Tensor] = {}
        self._fill: dict = {}
        for name, held in self.layers.items():
            pages = [tmpl[i][name] for i in held]
            t = pages[0]
            self._fill[name] = _constant(name, pages)
            rest = tuple(t.shape[2:])
            # page-major: a page of every layer is one contiguous block,
            # which index_select and index_copy_ move in long runs
            self.pool[name] = torch.full(
                (self.n_pages + 1, len(held), page_size, *rest),
                self._fill[name], dtype=t.dtype, device=t.device)
            self._buf[name] = torch.full(
                (len(held), slots, max_len + 1, *rest), self._fill[name],
                dtype=t.dtype, device=t.device)

        # state leaves (recurrent state, rings of more than max_len slots):
        # slot-resident rows, as init_cache allocates them (a ring with its
        # spare slot), and snapshot slots that prefix entries own
        full = model.init_cache(slots, max_len) if self.has_state else None
        self.static = {key: full[key[0]][key[1]] for key in static_keys}
        for key in static_keys:
            self._fill[key] = _constant(key[1], [probe[key[0]][key[1]]])
        self.n_snap = int(snap_slots) if (self.has_state
                                          and prefix_sharing) else 0
        self.snap = {key: torch.full((self.n_snap, *leaf.shape[1:]),
                                     self._fill[key], dtype=leaf.dtype,
                                     device=leaf.device)
                     for key, leaf in self.static.items()} if self.n_snap \
            else {}
        self._snap_free = list(range(self.n_snap - 1, -1, -1))

        # the cache prefill_chunk takes: per layer, [:, :max_len] of its
        # rows of each paged leaf's view (the spare slot behind them) and
        # its state leaves, in the model's order of leaves
        self.view = LayerCaches([
            {name: (self.static[(i, name)] if (i, name) in self.static else
                    self._buf[name][self.layers[name].index(i), :,
                                    :max_len])
             for name in names} for i, names in enumerate(self.names)],
            max_len)

        self.pages = PagePool(self.n_pages)
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
        device tensor of fixed shape, and the step does no host work.  The
        state leaves are the view's own: ``fn`` updates them in place."""
        self.gather(table, fresh)
        out = fn(self.view)
        self.scatter(rows, lps, phys)
        return out

    def gather(self, table, fresh) -> None:
        """Reset the ``fresh`` pages to the template, then copy each row's
        first g = ``len(table) / B`` pages into the view: one index_fill,
        one index_select and one copy (layer axis to the front) a paged
        leaf name, for every layer that holds it."""
        g = table.shape[0] // self.B
        for name, pool in self.pool.items():
            pool.index_fill_(0, fresh, self._fill[name])
            rows_g = pool.index_select(0, table).view(
                self.B, g, pool.shape[1], self.ps, *pool.shape[3:])
            self._buf[name][:, :, :g * self.ps].unflatten(
                2, (g, self.ps)).copy_(rows_g.movedim(2, 0))

    def scatter(self, rows, lps, phys) -> None:
        """Write the view's (row, logical page) pages back to their physical
        pages, every layer at once (padding triples write the sink)."""
        for pool, buf in zip(self.pool.values(), self._buf.values()):
            pages = buf[:, :, :self.max_len].unflatten(2, (self.n_pp, self.ps))
            pool.index_copy_(0, phys, pages.movedim(0, 2)[rows, lps])

    # -- state leaves and their snapshot slots ---------------------------------

    def reset_slot(self, b: int) -> None:
        """Reset row b of every state leaf to its template (pages need no
        reset here: they are freed, and a recycled page is reset when it is
        allocated)."""
        for key, leaf in self.static.items():
            leaf[b].fill_(self._fill[key])

    def snap_save(self, dst: int, b: int) -> None:
        """Copy row b of every state leaf into snapshot slot ``dst``."""
        for key, leaf in self.static.items():
            self.snap[key][dst].copy_(leaf[b])

    def snap_restore(self, src: int, b: int) -> None:
        """Copy snapshot slot ``src`` into row b of every state leaf."""
        for key, leaf in self.static.items():
            leaf[b].copy_(self.snap[key][src])

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
        preempts and retries).  With no paged leaf nothing is allocated."""
        if not self.has_paged or n <= 0:
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
        if not self.has_paged:
            return self.max_len
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
        """Point slot b's table at a shared prefix and restore its state
        snapshot.  The caller sets slot.pos = entry.length."""
        for lp, p in enumerate(entry.pages):
            assert int(self.tables[b, lp]) == 0
            self.pages.ref_inc(p)
            self.tables[b, lp] = p
        if entry.snap is not None:
            self.snap_restore(entry.snap, b)

    def register_prefix(self, b: int, tokens: list[int], length: int) -> bool:
        """Register slot b's first ``length`` (page-aligned) tokens: the
        entry holds a reference on each of their pages, and a copy of the
        row's state leaves in a snapshot slot.  Returns False when no
        snapshot slot can be had, even after evicting entries."""
        if not self.sharing or length <= 0 or length % self.ps:
            return False
        key = tuple(tokens[:length])
        if key in self.prefix.entries:
            return True
        snap = None
        if self.has_state:
            while not self._snap_free:
                if not self.evict_one():
                    return False
            snap = self._snap_free.pop()
            self.snap_save(snap, b)
        pages = [int(self.tables[b, lp]) for lp in range(length // self.ps)]
        assert all(pages) or not self.has_paged
        pages = [p for p in pages if p]
        for p in pages:
            self.pages.ref_inc(p)
        self.prefix.entries[key] = PrefixEntry(
            length=length, pages=pages, snap=snap,
            last_use=self.prefix.tick())
        return True

    def register_levels(self, b: int, tokens: list[int], length: int):
        """Register every page-aligned prefix level up to ``length``:
        entries share page references, so a later request matching any
        shared depth hits (a model with state leaves registers one level,
        ``register_prefix``: each costs a snapshot slot)."""
        for j in range(1, length // self.ps + 1):
            self.register_prefix(b, tokens, j * self.ps)

    def evict_one(self, require_free: bool = False) -> bool:
        """Drop the least-recently-used prefix entry, releasing its page
        references and its snapshot slot; pages still referenced by a live
        request stay resident.

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
            if e.snap is not None:
                self._snap_free.append(e.snap)
            return True
        return False

    # -- accounting / invariants ----------------------------------------------

    def nbytes(self) -> int:
        """Bytes of the page pool (the sink page included), the state leaves
        and their snapshot slots."""
        return sum(t.numel() * t.element_size() for t in (
            *self.pool.values(), *self.static.values(), *self.snap.values()))

    def pool_tokens(self) -> int:
        return (self.n_pages - 1) * self.ps if self.has_paged else 0

    def occupancy(self) -> dict:
        """Pool residency: usable pages (the zero page is reserved), free
        pages, and the occupied fraction.  Host-side counters only."""
        if not self.has_paged:
            return {"pages": 0, "pages_free": 0, "occupancy": 0.0}
        usable = self.n_pages - 1
        free = self.pages.n_free
        return {"pages": usable, "pages_free": free,
                "occupancy": (usable - free) / usable if usable else 0.0}

    def audit(self):
        """Invariant check (tests call this after every mutation batch):
        per-page refcounts equal table references + prefix-entry
        references; the free list is exactly the unreferenced pages,
        duplicate-free; the zero page still holds the template; each
        snapshot slot is owned by one entry or free, never both."""
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
        snaps = [e.snap for e in self.prefix.entries.values()
                 if e.snap is not None]
        assert len(snaps) == len(set(snaps)), "snapshot slot double-owned"
        assert set(snaps).isdisjoint(self._snap_free)
        assert len(self._snap_free) == len(set(self._snap_free))
        assert set(snaps) | set(self._snap_free) <= set(range(self.n_snap))
