"""Image segmentation: felzenszwalb, SLIC and quickshift (a copy of the JAX
package's ``ops/segmentation.py``, which imports no JAX; the port keeps its
own).

The reference's region-adaptive pipeline segments with
``skimage.segmentation.{felzenszwalb, slic, quickshift}``
(enhanced_local_style.py:56-74; felzenszwalb(scale=100, sigma=0.5,
min_size=50) is the default path). These are implementations of the
published algorithms with skimage-compatible parameters. They run on the
host (numpy): segmentation is per image, irregular and iterative, while
everything downstream of the label map (region statistics, blend maps) runs
on the device.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Felzenszwalb-Huttenlocher graph segmentation
# ---------------------------------------------------------------------------

class _DSU:
    __slots__ = ("parent", "rank", "size")

    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int32)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x):
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return ra


def _gaussian_smooth(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img.astype(np.float64)
    from scipy.ndimage import gaussian_filter

    out = np.empty(img.shape, np.float64)
    for c in range(img.shape[-1]):
        out[..., c] = gaussian_filter(img[..., c].astype(np.float64), sigma)
    return out


def felzenszwalb(image: np.ndarray, scale: float = 100.0, sigma: float = 0.5,
                 min_size: int = 50) -> np.ndarray:
    """Efficient graph-based segmentation (Felzenszwalb & Huttenlocher 2004),
    skimage-compatible parameters. image: (H, W, 3) uint8/float. Returns
    (H, W) int labels (0..n_segments-1).

    Matches skimage's formulation: 8-connected grid, Euclidean color
    distance on the (0..1-scaled) smoothed image, threshold tau(C)=scale/|C|.
    The union-find inner loop runs in native C++ when the repo's host
    library is built (the port's ``native`` module); this numpy path is the
    reference implementation and the fallback.
    """
    img = image.astype(np.float64)
    if img.max() > 1.0:
        img = img / 255.0
    img = _gaussian_smooth(img, sigma)

    from ..native import felzenszwalb_native

    native_labels = felzenszwalb_native(img.astype(np.float32), scale,
                                        min_size)
    if native_labels is not None:
        return native_labels.astype(np.int64)
    H, W = img.shape[:2]
    n = H * W
    idx = np.arange(n).reshape(H, W)

    edges_a, edges_b, weights = [], [], []

    def add(ai, bi, d):
        edges_a.append(ai.ravel())
        edges_b.append(bi.ravel())
        weights.append(d.ravel())

    diff = lambda a, b: np.sqrt(((a - b) ** 2).sum(-1))
    add(idx[:, :-1], idx[:, 1:], diff(img[:, :-1], img[:, 1:]))
    add(idx[:-1, :], idx[1:, :], diff(img[:-1, :], img[1:, :]))
    add(idx[:-1, :-1], idx[1:, 1:], diff(img[:-1, :-1], img[1:, 1:]))
    add(idx[1:, :-1], idx[:-1, 1:], diff(img[1:, :-1], img[:-1, 1:]))

    ea = np.concatenate(edges_a)
    eb = np.concatenate(edges_b)
    w = np.concatenate(weights)
    order = np.argsort(w, kind="stable")
    ea, eb, w = ea[order], eb[order], w[order]

    dsu = _DSU(n)
    threshold = np.full(n, scale, np.float64)  # tau = scale/1 initially
    for ai, bi, wi in zip(ea, eb, w):
        ra, rb = dsu.find(ai), dsu.find(bi)
        if ra == rb:
            continue
        if wi <= threshold[ra] and wi <= threshold[rb]:
            r = dsu.union(ra, rb)
            threshold[r] = wi + scale / dsu.size[r]

    # merge small components
    for ai, bi in zip(ea, eb):
        ra, rb = dsu.find(ai), dsu.find(bi)
        if ra != rb and (dsu.size[ra] < min_size or dsu.size[rb] < min_size):
            dsu.union(ra, rb)

    roots = np.fromiter((dsu.find(i) for i in range(n)), np.int64, n)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.reshape(H, W)


# ---------------------------------------------------------------------------
# SLIC superpixels
# ---------------------------------------------------------------------------

def _rgb_to_lab_np(img_u8):
    import cv2

    return cv2.cvtColor(img_u8.astype(np.uint8), cv2.COLOR_RGB2LAB
                        ).astype(np.float64)


def slic(image: np.ndarray, n_segments: int = 100, compactness: float = 10.0,
         max_iter: int = 10) -> np.ndarray:
    """SLIC superpixels (Achanta et al. 2012), skimage-compatible defaults.
    image: (H, W, 3) uint8. Returns (H, W) int labels."""
    H, W = image.shape[:2]
    lab = _rgb_to_lab_np(image)
    S = int(np.sqrt(H * W / n_segments)) or 1

    ys = np.arange(S // 2, H, S)
    xs = np.arange(S // 2, W, S)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers = np.stack([cy.ravel().astype(np.float64),
                        cx.ravel().astype(np.float64)], 1)
    feats = np.concatenate(
        [lab[cy.ravel(), cx.ravel()], centers * (compactness / S)], 1)

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix_grid = np.concatenate(
        [lab, np.stack([yy, xx], -1) * (compactness / S)], -1)  # (H, W, 5)

    K = len(centers)
    labels = np.zeros((H, W), np.int64)
    dist = np.full((H, W), np.inf)
    for _ in range(max_iter):
        dist[:] = np.inf
        # assignment: each center only touches its (2S+1)^2 window —
        # direct slicing, not full-image masks
        for k, (fy, fx) in enumerate(centers):
            y0, y1 = max(0, int(fy) - S), min(H, int(fy) + S + 1)
            x0, x1 = max(0, int(fx) - S), min(W, int(fx) + S + 1)
            d = ((pix_grid[y0:y1, x0:x1] - feats[k]) ** 2).sum(-1)
            better = d < dist[y0:y1, x0:x1]
            dist[y0:y1, x0:x1] = np.where(better, d, dist[y0:y1, x0:x1])
            labels[y0:y1, x0:x1] = np.where(better, k, labels[y0:y1, x0:x1])
        # center update: per-label means via bincount (O(N) not O(K*N));
        # centers with no members keep their previous position
        flat_labels = labels.ravel()
        counts = np.bincount(flat_labels, minlength=K)
        occupied = counts > 0
        denom = np.maximum(counts, 1)
        for c in range(5):
            sums = np.bincount(flat_labels,
                               weights=pix_grid[..., c].ravel(), minlength=K)
            feats[occupied, c] = (sums / denom)[occupied]
        centers = feats[:, 3:5] / (compactness / S)
    return labels


# ---------------------------------------------------------------------------
# Quickshift
# ---------------------------------------------------------------------------

def quickshift(image: np.ndarray, kernel_size: float = 3.0,
               max_dist: float = 6.0, ratio: float = 0.5) -> np.ndarray:
    """Quickshift mode-seeking segmentation (Vedaldi & Soatto 2008),
    skimage-parameter-compatible. O(H*W*window^2) numpy; fine at 256^2."""
    img = image.astype(np.float64)
    if img.max() > 1.0:
        img = img / 255.0
    H, W = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    feat = np.concatenate([img * ratio * 255.0,
                           np.stack([yy, xx], -1).astype(np.float64)], -1)

    w = int(np.ceil(3 * kernel_size))
    inv2k = -0.5 / (kernel_size ** 2)
    density = np.zeros((H, W))
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            sy0, sy1 = max(0, dy), min(H, H + dy)
            ty0, ty1 = max(0, -dy), min(H, H - dy)
            sx0, sx1 = max(0, dx), min(W, W + dx)
            tx0, tx1 = max(0, -dx), min(W, W - dx)
            d = ((feat[sy0:sy1, sx0:sx1] - feat[ty0:ty1, tx0:tx1]) ** 2
                 ).sum(-1)
            density[ty0:ty1, tx0:tx1] += np.exp(d * inv2k)

    parent_y = yy.copy()
    parent_x = xx.copy()
    best = np.full((H, W), np.inf)
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            if dy == 0 and dx == 0:
                continue
            dist2 = float(dy * dy + dx * dx)
            if dist2 > max_dist ** 2:
                continue
            sy0, sy1 = max(0, dy), min(H, H + dy)
            ty0, ty1 = max(0, -dy), min(H, H - dy)
            sx0, sx1 = max(0, dx), min(W, W + dx)
            tx0, tx1 = max(0, -dx), min(W, W - dx)
            nb_density = density[sy0:sy1, sx0:sx1]
            cur_density = density[ty0:ty1, tx0:tx1]
            d = ((feat[sy0:sy1, sx0:sx1] - feat[ty0:ty1, tx0:tx1]) ** 2
                 ).sum(-1)
            upgrade = (nb_density > cur_density) & (d < best[ty0:ty1, tx0:tx1])
            by = best[ty0:ty1, tx0:tx1]
            by[upgrade] = d[upgrade]
            best[ty0:ty1, tx0:tx1] = by
            py = parent_y[ty0:ty1, tx0:tx1]
            px = parent_x[ty0:ty1, tx0:tx1]
            py[upgrade] = (yy[ty0:ty1, tx0:tx1] + dy)[upgrade]
            px[upgrade] = (xx[ty0:ty1, tx0:tx1] + dx)[upgrade]
            parent_y[ty0:ty1, tx0:tx1] = py
            parent_x[ty0:ty1, tx0:tx1] = px

    # skimage semantics: a pixel whose nearest-higher-density parent is
    # farther than max_dist in FULL feature distance becomes its own root
    # (skimage quickshift: flat[dist_parent > max_dist] = self) — without
    # this, adjacent flat regions of very different color merge whenever
    # they touch spatially.
    too_far = best > max_dist ** 2
    parent_y = np.where(too_far, yy, parent_y)
    parent_x = np.where(too_far, xx, parent_x)

    flat = parent_y * W + parent_x
    # path-compress to roots
    for _ in range(64):
        nxt = flat.ravel()[flat]
        if (nxt == flat).all():
            break
        flat = nxt
    _, labels = np.unique(flat, return_inverse=True)
    return labels.reshape(H, W)
