"""Distributed top-N: sharded scoring, a top-k on each rank, one merge
(port of cmfrec_tpu/parallel/topn.py).

The reference scores every item with a gemv and partial-argsorts on the
host (upstream cmfrec src/common.c:5127-5370, src/helpers.c:1567).  Here
each rank scores its row share of the item factors, takes its local top-k
with ``torch.topk``, and one all-gather of world x k candidates resolves
the global top-n, the same on every rank.
"""

from __future__ import annotations

import torch

from .mesh import gather_rows, row_share, world_rank


def topn_sharded(a_vec, B, n_top, item_bias, mesh):
    """Top-n item ids and scores for one user vector over a mesh
    (cmfrec_tpu/parallel/topn.py:21-68).

    a_vec: [k]; B: [n, k], whole on every rank (each scores its share);
    item_bias: [n] or None.  Returns (idx [n_top], scores [n_top]) as
    tensors in descending score order, the same on every rank."""
    n = B.shape[0]
    world, _ = world_rank(mesh)
    pad = (-n) % world
    if pad:
        B = torch.cat([B, B.new_zeros(pad, B.shape[1])])
        if item_bias is not None:
            # padding rows never win: -inf bias
            item_bias = torch.cat([item_bias,
                                   item_bias.new_full((pad,), -torch.inf)])
    sl = row_share(n + pad, mesh)
    scores = B[sl] @ a_vec
    if item_bias is not None:
        scores = scores + item_bias[sl]
    if pad:
        gids = torch.arange(sl.start, sl.stop, device=B.device)
        scores = torch.where(gids < n, scores, -torch.inf)
    n_top = min(n_top, n)
    top_s, top_i = torch.topk(scores, min(n_top, sl.stop - sl.start))
    cand_s = gather_rows(top_s, mesh)
    cand_i = gather_rows(top_i + sl.start, mesh)
    fin_s, pos = torch.topk(cand_s, n_top)
    return cand_i[pos], fin_s
