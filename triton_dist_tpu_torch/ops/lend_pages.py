"""KV page lending: the cluster's prefix-sharing transport.

Counterpart of ``triton_dist_tpu/ops/lend_pages.py``: the same wire as
``migrate_pages`` (``ops.page_migrate.paged_transport``, TPU kernel B23),
under its own signal pad, with other roles: the lender copies cached
prefix pages that nobody references into a borrower's freshly allocated
pages and keeps its own copies (a replication, where a migration is a
handoff). The host checks the lender's pages (``check_lendable``) with the
prefix cache, which the port has not taken up yet (ROADMAP.md Queue A,
item 10); the transport itself is here.
"""

from __future__ import annotations

from triton_dist_tpu_torch.ops.page_migrate import paged_transport


def lend_pages(ctx, pool_k, pool_v, src_ids, dst_ids, n_pages,
               axis: str | None = None, lender: int = 0, borrower: int = 1,
               tag: int = 0):
    """Lend ``n_pages`` pages from ``lender`` to ``borrower`` over
    ``axis``: ``paged_transport``'s arguments and return, with
    ``landed[borrower] == (count, tag)`` the delivery the lending tier
    gates on."""
    return paged_transport(ctx, pool_k, pool_v, src_ids, dst_ids, n_pages,
                           axis=axis, producer=lender, consumer=borrower,
                           tag=tag, name="lend_pages")


__all__ = ["lend_pages"]
