"""The 3-stage Clos route of the mix permutations (port of
spectre_tpu/ops/routing.py), with numpy on the host and torch on tensors.

The mix backward is ``dxt[j] = sum_h g[h*d + inv[h, j]]``. Each ``inv[h]``
is a full permutation of d = r*c rows, and any such permutation factors
(Hall's theorem; the rearrangeability of a 3-stage Clos network) into

    within-row mix  ->  cross-row (per-column) mix  ->  within-row mix

over an [r, c] view of the rows. The factorisation is found on the host by
an Euler-split edge colouring of the bipartite multigraph {source row block
-> destination row block, one edge per element}, which is c-regular: halving
it along Euler circuits, log2(c) times, gives the c perfect matchings that
are the c columns of the route.

On a TPU the route sidesteps the (8, 128) tiling of device memory. On a GPU a
row is B contiguous values and is read directly, so the three stages compose
into one source row per (head, output row); the hand-written kernel
(ops/kernels/routed_gather.py) reads the three tables and does that. This
module keeps the tables (bit for bit the JAX package's, from the same
inverse permutations), their disk cache, and the two jnp applications of the
route as torch ops: ``route_gather_sum`` (three gathers) and
``route_gather_sum_mxu`` (three one-hot products).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

# the port's own cache of route tables: build/routes/ at the repository root
# (ignored by git), beside the built kernels
ROUTE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "routes")


def _euler_split(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2-colour the edges of an even-regular bipartite multigraph so that
    every vertex (either side) gets exactly half of its edges in each colour.

    Walks Euler circuits (Hierholzer), alternating colours along each; a
    circuit in a bipartite graph has even length and passes each vertex by
    pairs of edges, so the alternation splits every vertex's edges evenly.
    The same walk as the JAX package's, over Python lists (indexing a list
    is several times cheaper than indexing a numpy array element by element),
    so the colouring is the same.
    """
    m = len(src)
    if m == 0:
        return np.zeros(0, dtype=np.int8)
    order_l = np.argsort(src, kind="stable")
    order_r = np.argsort(dst, kind="stable")
    n_l, n_r = int(src.max()) + 1, int(dst.max()) + 1
    start_l = np.searchsorted(src[order_l], np.arange(n_l)).tolist()
    start_r = np.searchsorted(dst[order_r], np.arange(n_r)).tolist()
    end_l = np.searchsorted(src[order_l], np.arange(n_l), side="right").tolist()
    end_r = np.searchsorted(dst[order_r], np.arange(n_r), side="right").tolist()
    src_l, dst_l = src.tolist(), dst.tolist()
    order_l, order_r = order_l.tolist(), order_r.tolist()
    ptr_l, ptr_r = start_l, start_r
    color = [0] * m
    used = [False] * m

    for e0 in range(m):
        if used[e0]:
            continue
        e, col, at_left = e0, 0, True  # departing from the left endpoint
        while True:
            used[e] = True
            color[e] = col
            col ^= 1
            # land on the other endpoint; depart by its next unused edge
            if at_left:
                node, order, ptr, end = dst_l[e], order_r, ptr_r, end_r
            else:
                node, order, ptr, end = src_l[e], order_l, ptr_l, end_l
            i, stop = ptr[node], end[node]
            while i < stop and used[order[i]]:
                i += 1
            ptr[node] = i
            if i == stop:
                break  # circuit closed (all degrees even: only at the start)
            e = order[i]
            at_left = not at_left
    return np.asarray(color, dtype=np.int8)


def edge_color(src: np.ndarray, dst: np.ndarray, k: int) -> np.ndarray:
    """Colour the edges of a k-regular bipartite multigraph with k colours
    so that each (vertex, colour) pair occurs exactly once; k a power of 2."""
    if k == 1:
        return np.zeros(len(src), dtype=np.int32)
    if k & (k - 1):
        raise ValueError(f"edge_color needs a power-of-two regularity, got {k}")
    half = _euler_split(src, dst)
    out = np.empty(len(src), dtype=np.int32)
    for b in (0, 1):
        m = half == b
        out[m] = 2 * edge_color(src[m], dst[m], k // 2) + b
    return out


def pick_factor(d: int, c_max: int = 128) -> int:
    """Largest power-of-two column count c <= c_max with c | d (and c >= 8),
    or 0 when d has no usable power-of-two factor."""
    c = d & (-d)  # largest power of 2 dividing d
    c = min(c, c_max)
    return c if c >= 8 else 0


@dataclass(frozen=True)
class RouteTables:
    """Per-head 3-stage route for ``y[j] = sum_h g[h*d + inv[h, j]]``.

    With the [d] axis viewed as [r, c] (q = i // c, s = i % c):
      stage A: out1[h, q, t] = g[h, q, a_idx[h, q, t]]      (within a row)
      stage B: out2[h, q, t] = out1[h, b_idx[h, q, t], t]   (across rows)
      stage C: y[q, s]       = sum_h out2[h, q, c_idx[h, q, s]]
    """

    r: int
    c: int
    a_idx: np.ndarray  # [H, r, c] int32
    b_idx: np.ndarray  # [H, r, c] int32
    c_idx: np.ndarray  # [H, r, c] int32


def build_route_tables(inv: np.ndarray, c: int | None = None) -> RouteTables:
    """Factor each head's inverse permutation into the 3-stage route.

    ``inv``: [H, d] ints, each row a permutation of range(d): output row j of
    head h reads source row inv[h, j] of that head's slice.
    """
    inv = np.asarray(inv)
    h_n, d = inv.shape
    c = pick_factor(d) if c is None else c
    if not c or d % c:
        raise ValueError(f"no usable power-of-two factor for d={d} (c={c})")
    r = d // c
    j = np.arange(d)
    qd, sd = j // c, j % c
    a_idx = np.empty((h_n, r, c), dtype=np.int32)
    b_idx = np.empty((h_n, r, c), dtype=np.int32)
    c_idx = np.empty((h_n, r, c), dtype=np.int32)
    for h in range(h_n):
        sig = inv[h]
        qs, ss = sig // c, sig % c
        t = edge_color(qs, qd, c)
        a_idx[h, qs, t] = ss
        b_idx[h, qd, t] = qs
        c_idx[h, qd, sd] = t
    return RouteTables(r=r, c=c, a_idx=a_idx, b_idx=b_idx, c_idx=c_idx)


def build_route_tables_cached(inv: np.ndarray, c: int | None = None,
                              cache_dir: str | None = None) -> RouteTables:
    """``build_route_tables`` through a disk cache: the tables are pure
    functions of the permutations, and the colouring is a Python loop of
    some H * d * log2(c) steps. ``cache_dir`` defaults to ``ROUTE_CACHE_DIR``;
    a file is ``<sha1 of inv and c>.npz``, written under a temporary name and
    renamed, so a reader never sees half a file."""
    inv = np.ascontiguousarray(np.asarray(inv, dtype=np.int32))
    tag = hashlib.sha1(inv.tobytes() + str(c).encode()).hexdigest()  # noqa: S324 (cache key)
    cdir = ROUTE_CACHE_DIR if cache_dir is None else cache_dir
    path = os.path.join(cdir, f"{tag}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return RouteTables(r=int(z["r"]), c=int(z["c"]), a_idx=z["a"], b_idx=z["b"],
                               c_idx=z["cc"])
    rt = build_route_tables(inv, c)
    os.makedirs(cdir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:  # np.savez would append .npz to a bare path
        np.savez(f, r=rt.r, c=rt.c, a=rt.a_idx, b=rt.b_idx, cc=rt.c_idx)
    os.replace(tmp, path)
    return rt


def _expand(idx: torch.Tensor, b: int) -> torch.Tensor:
    """[..., r, c] int -> [..., r, c, B] int64 index for ``torch.gather``
    (a stride-0 view over B, nothing copied)."""
    return idx.long()[..., None].expand(*idx.shape, b)


def route_gather_sum(g: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor,
                     c_idx: torch.Tensor) -> torch.Tensor:
    """The route applied by three gathers, then one sum over the heads in
    g's dtype: g [H*d, B] -> [d, B] with tables [H, r, c] on g's device (the
    JAX ``route_gather_sum``'s ``take_along_axis`` form)."""
    h, r, c = a_idx.shape
    b = g.shape[-1]
    gv = g.reshape(h, r, c, b)
    out1 = torch.gather(gv, 2, _expand(a_idx, b))
    out2 = torch.gather(out1, 1, _expand(b_idx, b))
    y = torch.gather(out2, 2, _expand(c_idx, b))
    return y.sum(dim=0).reshape(r * c, b)


def route_onehots(a_idx: torch.Tensor, b_idx: torch.Tensor, c_idx: torch.Tensor,
                  dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense one-hot stage operators, built on the tables' device:

        oh_a [H, r, c, c]: oh_a[h, q, t, s] = 1 iff a_idx[h, q, t] == s
        oh_b [H, c, r, r]: oh_b[h, t, q, p] = 1 iff b_idx[h, q, t] == p
        oh_c [H, r, c, c]: oh_c[h, q, s, t] = 1 iff c_idx[h, q, s] == t

    At the flagship shape (H=16, r=260, c=128) they hold about 0.55 GB in
    bf16 per mix layer (0.14 + 0.28 + 0.14 GB); the model builds them once per
    table and keeps them on the device."""
    _, r, c = a_idx.shape
    cols = torch.arange(c, device=a_idx.device, dtype=a_idx.dtype)
    rows = torch.arange(r, device=a_idx.device, dtype=a_idx.dtype)
    oh_a = (a_idx[..., None] == cols).to(dtype)
    oh_b = (b_idx.transpose(1, 2)[..., None] == rows).to(dtype)
    oh_c = (c_idx[..., None] == cols).to(dtype)
    return oh_a, oh_b, oh_c


def route_gather_sum_mxu(g: torch.Tensor, oh_a: torch.Tensor, oh_b: torch.Tensor,
                         oh_c: torch.Tensor) -> torch.Tensor:
    """The route applied by three one-hot products (the JAX
    ``route_gather_sum_mxu``, written for the TPU's matrix unit): each value
    passes through a product with ones and zeros unchanged, and the last
    product contracts the head and the colour together. Not a kernel of the
    port's; ``torch.einsum`` on whatever device g lies."""
    h, r, c, _ = oh_a.shape
    gv = g.reshape(h, r, c, -1)
    out1 = torch.einsum("hqts,hqsb->hqtb", oh_a, gv)
    out2 = torch.einsum("htqp,hptb->hqtb", oh_b, out1)
    y = torch.einsum("hqst,hqtb->qsb", oh_c, out2)
    return y.reshape(r * c, -1).to(g.dtype)
