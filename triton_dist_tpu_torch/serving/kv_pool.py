"""Paged KV block allocator over the ``[P, Hkv, page_size, D]`` page pool
that ``ops.flash_decode.gqa_decode_paged`` reads, and the converters between
a contiguous cache and the pool.

Counterpart of ``triton_dist_tpu/serving/kv_pool.py``:

- **host accounting**: ``KVPagePool``, the reference's ledger for one
  device — a LIFO free list over page ids with per-sequence ownership,
  allocate-on-decode growth and free-on-finish. Pure Python and
  deterministic: replaying a trace allocates the same pages. It carries the
  reference's SP device layout (``sp_ranks``, ``layout``, ``device_row``,
  ``page_shard``): the map from ledger ids to rows of the device pool, and
  its ``digest``, and the disaggregated engine's migration checks
  (``check_migratable``, ``landed_row``). The prefix-cache refcounts, the
  copy-on-write path, snapshots and the lending check (``check_lendable``)
  of the reference ledger belong to a later slice (ROADMAP.md Queue A,
  item 10) and are not here.
- **device memory**: ``models.llama.init_page_pool`` tensors. Nothing in the
  ledger looks at their values. ``cache_to_pages`` / ``pages_to_cache``
  move whole pages between the head-major contiguous ``init_kv_cache``
  layout and the pool (bit-exact round trip).
"""

from __future__ import annotations

import torch


def _fnv1a(h: int, *words: int) -> int:
    """Fold ints into a 32-bit FNV-1a state (4 bytes each, two's
    complement for negative values); the scheduler's digest uses it."""
    for w in words:
        w &= 0xFFFFFFFF
        for shift in (0, 8, 16, 24):
            h ^= (w >> shift) & 0xFF
            h = (h * 0x01000193) & 0xFFFFFFFF
    return h


class PageLedgerError(AssertionError):
    """Page-accounting corruption: double free, freeing a foreign page, a
    row wider than the block table. Raised explicitly (not via a bare
    ``assert``) so detection survives ``python -O``; subclasses
    ``AssertionError`` because callers catch the ledger checks as such."""


class KVPagePool:
    """Host-side free-list allocator over ``num_pages`` page ids.

    Invariants (``check()`` audits them):
    - a page id is owned by at most one sequence at a time;
    - the ``reserved`` low ids are never handed out (the engine parks
      inactive batch rows on page 0; their writes must never land on a live
      sequence's page);
    - alloc is all-or-nothing: a request for ``n`` pages either returns
      ``n`` ids or ``None`` and changes nothing.
    The free list is LIFO, so allocation order is deterministic.

    ``sp_ranks`` is the size of the SP axis the device pool is split over on
    its page dim; the device pool holds ``device_pages`` rows, the page count
    padded up to a multiple of ``sp_ranks`` (the padding rows are never
    handed out). ``layout`` maps ledger ids to device rows:

    - ``"blocked"`` (default): row == id, consecutive ids on one SP shard;
    - ``"interleaved"``: row ``(id % sp_ranks) * (device_pages / sp_ranks)
      + id // sp_ranks``, consecutive ids round-robin over the SP shards, so
      one long sequence's pages spread evenly (the long-context serving
      mode).

    Either way the map is a bijection over ``[0, device_pages)`` with row 0
    fixed, and pure device layout: allocation decisions never see it.
    """

    def __init__(self, num_pages: int, page_size: int, reserved: int = 0,
                 sp_ranks: int = 1, layout: str = "blocked"):
        assert num_pages > reserved >= 0
        assert sp_ranks >= 1
        assert layout in ("blocked", "interleaved"), (
            f"layout must be 'blocked' or 'interleaved', got {layout!r}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.reserved = reserved
        self.sp_ranks = sp_ranks
        self.layout = layout
        self.device_pages = num_pages + (-num_pages) % sp_ranks
        # LIFO: lowest ids on top, so a fresh pool allocates reserved, 1, 2…
        self._free = list(range(num_pages - 1, reserved - 1, -1))
        self._owned: dict[object, list[int]] = {}

    # -- introspection ----------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - self.reserved) - len(self._free)

    def occupancy(self) -> float:
        cap = self.num_pages - self.reserved
        return self.used_pages / cap if cap else 0.0

    def pages_of(self, seq_id) -> list[int]:
        return list(self._owned.get(seq_id, ()))

    def device_row(self, page_id: int) -> int:
        """The row of the device pool that holds ledger page ``page_id``:
        the id itself under ``"blocked"``, the round-robin bijection under
        ``"interleaved"``. Every id that goes to the device (block-table
        entries, host-side pool gathers and scatters) goes through here."""
        if not 0 <= page_id < self.device_pages:
            raise PageLedgerError(
                f"page {page_id} outside the device range "
                f"[0, {self.device_pages})")
        if self.layout == "blocked":
            return page_id
        return ((page_id % self.sp_ranks)
                * (self.device_pages // self.sp_ranks)
                + page_id // self.sp_ranks)

    def page_shard(self, page_id: int) -> int:
        """The SP rank whose shard of the device pool (an even split of the
        padded page dim) holds ``page_id``. Layout introspection only: no
        allocation decision may depend on it."""
        return self.device_row(page_id) \
            // (self.device_pages // self.sp_ranks)

    # -- allocation -------------------------------------------------------
    def alloc(self, seq_id, n_pages: int) -> list[int] | None:
        """Grow ``seq_id`` by ``n_pages``; all-or-nothing. Returns the new
        page ids or ``None`` when the pool is dry."""
        if n_pages > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n_pages)]
        self._owned.setdefault(seq_id, []).extend(got)
        return got

    def _release_page(self, seq_id, p: int) -> None:
        if p in self._free:
            raise PageLedgerError(f"double free of page {p} (seq {seq_id!r})")
        self._free.append(p)

    def ensure(self, seq_id, kv_len: int) -> bool:
        """Allocate-on-decode growth: make ``seq_id`` own enough pages to
        hold ``kv_len`` tokens. True on success (including no-op), False
        when the pool is dry (the caller preempts and retries)."""
        have = len(self._owned.get(seq_id, ()))
        need = -(-kv_len // self.page_size) - have
        if need <= 0:
            return True
        return self.alloc(seq_id, need) is not None

    def free_tail(self, seq_id, keep: int) -> int:
        """Free every page of ``seq_id`` past the first ``keep`` — the
        mid-prefill preemption primitive: pages already holding computed KV
        stay owned, only the unfilled tail returns. Freed in allocation
        order, so replay stays deterministic. Returns how many were freed."""
        pages = self._owned.get(seq_id, [])
        if not 0 <= keep <= len(pages):
            raise PageLedgerError(
                f"free_tail(keep={keep}) out of range for seq {seq_id!r} "
                f"owning {len(pages)} pages")
        tail = pages[keep:]
        for p in tail:
            self._release_page(seq_id, p)
        if keep:
            self._owned[seq_id] = pages[:keep]
        else:
            self._owned.pop(seq_id, None)
        return len(tail)

    def free_seq(self, seq_id) -> int:
        """Free-on-finish (and on preemption): return every page of
        ``seq_id`` to the free list. Returns how many were freed."""
        pages = self._owned.pop(seq_id, [])
        for p in pages:
            self._release_page(seq_id, p)
        return len(pages)

    def check(self) -> None:
        """Full-invariant audit; raises ``PageLedgerError`` with the first
        violation: every free and owned id is in ``[reserved, num_pages)``
        and appears once; no id is both free and owned; free plus owned
        account for every non-reserved page."""
        owner: dict[int, object] = {}
        for sid, pages in self._owned.items():
            for p in pages:
                if not (self.reserved <= p < self.num_pages):
                    raise PageLedgerError(
                        f"seq {sid!r} owns out-of-range page {p}")
                if p in owner:
                    raise PageLedgerError(
                        f"page {p} owned by both {owner[p]!r} and {sid!r}")
                owner[p] = sid
        free = set(self._free)
        if len(free) != len(self._free):
            raise PageLedgerError("duplicate ids on the free list")
        for p in free:
            if not (self.reserved <= p < self.num_pages):
                raise PageLedgerError(f"out-of-range page {p} on free list")
            if p in owner:
                raise PageLedgerError(
                    f"page {p} is both free and owned by seq {owner[p]!r}")
        if len(free) + len(owner) != self.num_pages - self.reserved:
            raise PageLedgerError(
                f"page conservation violated: {len(free)} free + "
                f"{len(owner)} owned != {self.num_pages - self.reserved} "
                "non-reserved pages")

    def digest(self) -> int:
        """Order-sensitive 32-bit FNV-1a digest of the ledger, the
        reference's fold over this ledger's state: the geometry, the free
        list in order, the ownership map in insertion order, then the
        prefix-cache state, which here is one reference per owned page and
        nothing cached. ``sp_ranks`` and ``layout`` never enter it: they are
        device layout, not allocation decisions. Two ledgers that made the
        same decisions digest alike, under either layout."""
        h = _fnv1a(0x811C9DC5, self.num_pages, self.page_size, self.reserved)
        h = _fnv1a(h, len(self._free), *self._free)
        for sid, pages in self._owned.items():
            h = _fnv1a(h, hash(sid) & 0xFFFFFFFF, len(pages), *pages)
        for p in sorted(p for pages in self._owned.values() for p in pages):
            h = _fnv1a(h, p, 1)
        return _fnv1a(_fnv1a(h, 0), 0)     # no cached, no cacheable pages

    # -- migration (the disaggregated engine) ------------------------------
    def check_migratable(self, seq_id, page_ids) -> None:
        """Migration precondition: every id in ``page_ids`` is owned by
        ``seq_id``, is not a reserved scratch page (parked rows write to it
        every dispatch, so it would plant changing garbage in the peer's
        pool) and is a real page below ``num_pages`` (an SP padding row is
        never exposed by a block table). Raises ``PageLedgerError``. Each
        page has one owner here (no prefix-cache sharing), which is the
        reference's sole-ownership clause."""
        owned = set(self._owned.get(seq_id, ()))
        for p in page_ids:
            if p < self.reserved:
                raise PageLedgerError(
                    f"page {p} is a reserved scratch page — scratch pages "
                    f"are never migrated (seq {seq_id!r})")
            if p >= self.num_pages:
                raise PageLedgerError(
                    f"page {p} is an SP padding/out-of-range id (real pages "
                    f"end at {self.num_pages}, the device pool pads to "
                    f"{self.device_pages}) — padding pages are never "
                    f"migrated (seq {seq_id!r})")
            if p not in owned:
                raise PageLedgerError(
                    f"page {p} is not owned by seq {seq_id!r} — refusing "
                    "to migrate a foreign page")

    def landed_row(self, seq_id, covered, pages_per_seq: int,
                   fill: int = 0) -> list[int]:
        """Block-table row exposing only the landed prefix of ``seq_id``'s
        pages: page i holds tokens ``[i * page_size, (i + 1) * page_size)``,
        so it is usable only when it and every page before it are in
        ``covered`` (the ids whose delivery signals have fired). Entries
        past the prefix are ``fill``, the scratch page: the decode side
        never reads a page before its signal."""
        row: list[int] = []
        for p in self._owned.get(seq_id, []):
            if p not in covered:
                break
            row.append(p)
        if len(row) > pages_per_seq:
            raise PageLedgerError(
                f"seq {seq_id!r} landed {len(row)} pages > pages_per_seq "
                f"{pages_per_seq}")
        return row + [fill] * (pages_per_seq - len(row))

    def holds(self, seq_id) -> bool:
        """Whether ``seq_id`` owns any page."""
        return seq_id in self._owned

    def block_table_row(self, seq_id, pages_per_seq: int,
                        fill: int = 0) -> list[int]:
        """Fixed-width block-table row: owned pages, then ``fill`` (the
        scratch page; entries past the live pages are never read by
        ``gqa_decode_paged``)."""
        pages = self._owned.get(seq_id, [])
        if len(pages) > pages_per_seq:
            raise PageLedgerError(
                f"seq {seq_id!r} owns {len(pages)} pages > pages_per_seq "
                f"{pages_per_seq}")
        return pages + [fill] * (pages_per_seq - len(pages))


# ---------------------------------------------------------------------------
# the device pool's layout over the SP ranks
# ---------------------------------------------------------------------------

def page_pool_pspec(axis: str | None) -> tuple:
    """How the ``[L, P, Hkv, page_size, D]`` pool arrays are laid over the
    mesh (the JAX ``page_pool_pspec``'s spec as a tuple): pages sharded
    over ``axis``, everything else replicated. The port keeps the pool as
    its global view, rank r's shard at pages ``[r * P / n, (r + 1) * P /
    n)``."""
    return (None, axis, None, None, None)


def shard_pool_arrays(pool: dict, sp_ranks: int) -> dict:
    """Pad the ``{"k", "v"}`` pool arrays' page dim (dim 1) with zero pages
    up to a multiple of ``sp_ranks``, the SP shards' even split. The
    allocator never hands out a padding page (``KVPagePool(sp_ranks=...)``
    counts them in ``device_pages`` only), so no block table names one.
    Arrays already a multiple come back as they are."""
    pad = (-pool["k"].shape[1]) % sp_ranks
    if not pad:
        return pool
    return {k: torch.cat([v, torch.zeros(v.shape[:1] + (pad,) + v.shape[2:],
                                         dtype=v.dtype, device=v.device)], 1)
            for k, v in pool.items()}


# ---------------------------------------------------------------------------
# contiguous cache <-> page pool converters
# ---------------------------------------------------------------------------

def cache_to_pages(cache, pages, block_table):
    """Scatter a head-major contiguous cache into the page pool, in place.

    cache [L, B, Hkv, S, D] (``init_kv_cache`` layout, one of k/v); pages
    [L, P, Hkv, page_size, D]; block_table [B, n_pages] int with
    ``n_pages * page_size <= S``. Writes ``cache[:, b, :, p*ps:(p+1)*ps]``
    into ``pages[:, bt[b, p]]`` for every (b, p), whole pages. Returns
    ``pages``."""
    L, B, Hkv, S, D = cache.shape
    ps = pages.shape[3]
    n_pages = block_table.shape[1]
    assert n_pages * ps <= S, (n_pages, ps, S)
    src = cache[:, :, :, :n_pages * ps].reshape(L, B, Hkv, n_pages, ps, D)
    src = src.permute(0, 1, 3, 2, 4, 5).reshape(L, B * n_pages, Hkv, ps, D)
    pages[:, block_table.reshape(-1).long()] = src
    return pages


def pages_to_cache(pages, block_table):
    """Gather pool pages back into a contiguous head-major cache, the exact
    inverse of ``cache_to_pages``. pages [L, P, Hkv, ps, D]; block_table
    [B, n_pages] → [L, B, Hkv, n_pages*ps, D]."""
    L = pages.shape[0]
    Hkv, ps, D = pages.shape[2:]
    B, n_pages = block_table.shape
    g = pages[:, block_table.reshape(-1).long()]   # [L, B*n_pages, Hkv, ps, D]
    g = g.reshape(L, B, n_pages, Hkv, ps, D).permute(0, 1, 3, 2, 4, 5)
    return g.reshape(L, B, Hkv, n_pages * ps, D)


__all__ = ["KVPagePool", "PageLedgerError", "cache_to_pages",
           "pages_to_cache", "page_pool_pspec", "shard_pool_arrays",
           "_fnv1a"]
