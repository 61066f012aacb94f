#!/usr/bin/env python3
"""Time forms of the paged step's gather and scatter on one card, at the
cache leaves of llama7b-blast (32 layers, 32 kv heads of 128) and
smollm-135m (30 layers, 3 kv heads of 64): bf16 ``k`` and ``v`` and the
int32 ``pos``, 8 slots, 512 positions, pages of 16.

    python3 scripts/paged_gather_ab.py

Gather, for 4, 16 and 32 pages a row (kv 64, 256, 512), after resetting 8
fresh pages (``index_fill_``), into the view ``(layers, slots, 513, ...)``
that ``prefill_chunk`` reads:

  * ``temp``: layer-major pool ``(layers, pages + 1, page, ...)``;
    ``index_select`` of the pages into a temporary, then one strided copy
    into the view: two calls a leaf;
  * ``per_row``: the same pool; ``index_select`` straight into each row's
    slice of the view (``out=``), no temporary: one call a row and leaf;
  * ``page_major``: the pool ``(pages + 1, layers, page, ...)``;
    ``index_select`` on its first axis into a temporary, then a permuted
    copy into the view: two calls a leaf (``serve/paged.py``'s form).

Scatter of M = 8 and 32 (row, logical page) pages of the view back to the
pool: ``layer_major`` (``index_copy_`` on the pool's axis 1 from the
view's pages) and ``page_major`` (``index_copy_`` on axis 0, as
``serve/paged.py`` does).

Every form must leave the same values as the first.  Prints one JSON line a
(model, operation, size): each form's device ms (``chip_smoke.time_ms``:
median of 25, L2 flushed) and the bound, the bytes the operation must move
(a gathered or scattered page read once and written once, a fresh page
written once) over the HBM rate; then the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

B, S, PS, F = 8, 512, 16, 8
MODELS = {"llama7b-blast": (32, 32, 128), "smollm-135m": (30, 3, 64)}


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("paged_gather_ab: no CUDA device")
    dev = "cuda"
    n_pp = S // PS
    n_pages = B * n_pp + 1
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for arch, (L, H, D) in MODELS.items():
        rest = {"k": (H, D), "v": (H, D), "pos": ()}
        dtype = {"k": torch.bfloat16, "v": torch.bfloat16, "pos": torch.int32}
        fill = {"k": 0, "v": 0, "pos": -1}
        pool = {n: torch.randn((L, n_pages + 1, PS, *rest[n]), generator=gen,
                               device=dev).mul(100).to(dtype[n])
                for n in rest}
        pool_pm = {n: p.transpose(0, 1).contiguous() for n, p in pool.items()}
        layouts = {"temp": pool, "per_row": pool, "page_major": pool_pm}
        views = {f: {n: torch.zeros((L, B, S + 1, *rest[n]), device=dev,
                                    dtype=dtype[n]) for n in rest}
                 for f in layouts}
        page_bytes = sum(p[:, 0].numel() * p.element_size()
                         for p in pool.values())
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        fresh = perm[-F:]
        for g in (4, 16, 32):
            table = perm[:B * n_pp].view(B, n_pp)[:, :g].reshape(-1)
            table = table.contiguous()
            rows = [table[b * g:(b + 1) * g] for b in range(B)]

            def temp():
                for n, p in pool.items():
                    p.index_fill_(1, fresh, fill[n])
                    t = p.index_select(1, table)
                    views["temp"][n][:, :, :g * PS].copy_(
                        t.view(L, B, g * PS, *rest[n]))

            def per_row():
                for n, p in pool.items():
                    p.index_fill_(1, fresh, fill[n])
                    for b in range(B):
                        torch.index_select(
                            p, 1, rows[b], out=views["per_row"][n][
                                :, b, :g * PS].unflatten(1, (g, PS)))

            def page_major():
                for n, p in pool_pm.items():
                    p.index_fill_(0, fresh, fill[n])
                    t = p.index_select(0, table).view(B, g, L, PS, *rest[n])
                    views["page_major"][n][:, :, :g * PS].unflatten(
                        2, (g, PS)).copy_(t.movedim(2, 0))

            forms = {"temp": temp, "per_row": per_row,
                     "page_major": page_major}
            for fn in forms.values():
                fn()
            torch.cuda.synchronize()
            for f in ("per_row", "page_major"):
                if any(not torch.equal(views[f][n][:, :, :g * PS],
                                       views["temp"][n][:, :, :g * PS])
                       for n in rest):
                    raise RuntimeError(f"{arch}: the {f} gather differs "
                                       f"from temp at {g} pages a row")
            moved = (2 * B * g + F) * page_bytes
            row = {"arch": arch, "op": "gather", "pages_per_row": g,
                   "kv": g * PS, "fresh": F, "bytes": moved,
                   "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3}
            row.update({f"{f}_ms": cs.time_ms(fn, flush)
                        for f, fn in forms.items()})
            print(json.dumps(row), flush=True)
        for M in (8, 32):
            rows_m = torch.arange(M, device=dev) % B
            lps_m = torch.arange(M, device=dev) // B
            phys = perm[:M].contiguous()
            view = views["temp"]

            def layer_major():
                for n, p in pool.items():
                    pages = view[n][:, :, :S].unflatten(2, (n_pp, PS))
                    p.index_copy_(1, phys, pages[:, rows_m, lps_m])

            def page_major_s():
                for n, p in pool_pm.items():
                    pages = view[n][:, :, :S].unflatten(2, (n_pp, PS))
                    p.index_copy_(0, phys, pages.movedim(0, 2)[rows_m, lps_m])

            forms = {"layer_major": layer_major, "page_major": page_major_s}
            for fn in forms.values():
                fn()
            torch.cuda.synchronize()
            if any(not torch.equal(pool_pm[n], pool[n].transpose(0, 1))
                   for n in rest):
                raise RuntimeError(f"{arch}: the page-major scatter differs")
            moved = 2 * M * page_bytes
            row = {"arch": arch, "op": "scatter", "pages": M, "bytes": moved,
                   "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3}
            row.update({f"{f}_ms": cs.time_ms(fn, flush)
                        for f, fn in forms.items()})
            print(json.dumps(row), flush=True)
        del pool, pool_pm, views
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
