"""Random-forest classifier, fit on one device with every tree at once,
or with the trees sharded over a mesh (port of the reference's ``models/forest.py``, the tree model behind
the classification template's RandomForest variant,
RandomForestAlgorithm.scala: MLlib ``RandomForest.trainClassifier`` with
numClasses/numTrees/featureSubsetStrategy/impurity/maxDepth/maxBins).

* Features are quantized once on the host into ``max_bins`` quantile
  bins (MLlib's binning), so split search is integer histogramming. The
  binning, the bootstrap indices and the per-(tree, node) feature masks
  are numpy with the reference's ``np.random.default_rng(seed)`` stream,
  so they are bit-identical to the reference's.
* Every tree is a COMPLETE binary array of depth ``max_depth`` grown
  breadth-first, all trees at once, one level at a time on the device:
  one ``torch.bincount`` over the cell id ``((((tree * width + node) * F
  + f) * B + bin) * C + class)`` of every (tree, bagged sample, feature)
  builds the level's ``[T, width, F, B, C]`` histogram (integer counts,
  exact); a cumulative sum over bins gives the left/right class counts
  of each threshold; ``_impurity_cost`` runs the reference's formula in
  its order of f32 operations; the last bin (everything left) and the
  features outside the node's mask get ``+inf``; the first minimum of
  each node's ``(feature, bin)`` surface is its split; the samples route
  by it. The histogram takes as many trees a call as fit
  ``HIST_ELEMENTS`` cell ids.
* A node with no valid split (pure, or empty under bootstrap) stores the
  sentinel threshold B-1, so every sample routes left and the leaf
  majority is unchanged: the shape-static form of MLlib's early leaf.
* Prediction walks all trees in lockstep on the device ([T, N] gathers
  per level) and takes the majority vote; a tie goes to the lowest class
  code (the first maximum of the vote counts).

With a ``mesh`` of more than one position the trees shard over its
first axis (the embarrassingly parallel axis MLlib also splits by): the
bags and masks are drawn for the requested tree count, so the random
stream does not depend on the mesh; the count pads to a multiple of the
axis with copies of tree 0; each position fits its run of trees with
:func:`_fit_forest` on its device from the whole binned data; one
``all_gather`` over the axis collects the node arrays, and the padding
is sliced off, so the model is the one-device model whatever the mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.utils.device import resolve_device

#: cell ids of one histogram call (int32 each): the trees of a level go
#: through ``torch.bincount`` in groups of at most this many (tree,
#: sample, feature) entries
HIST_ELEMENTS = 1 << 29


@dataclasses.dataclass
class ForestParams(Params):
    """RandomForestAlgorithmParams parity."""

    num_classes: int = 0                  # 0 = infer from labels
    num_trees: int = 10
    feature_subset_strategy: str = "auto"   # auto|all|sqrt|onethird
    impurity: str = "gini"                  # gini|entropy
    max_depth: int = 4
    max_bins: int = 32
    seed: int = 0


def _subset_size(strategy: str, n_features: int) -> int:
    s = strategy.lower()
    if s == "auto" or s == "sqrt":
        # MLlib classification "auto" = sqrt
        return max(1, int(np.ceil(np.sqrt(n_features))))
    if s == "onethird":
        return max(1, int(np.ceil(n_features / 3)))
    if s == "all":
        return n_features
    raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")


def _sum_classes(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (class) axis, left to right: the reference's
    f32 reduction order over a few classes."""
    s = x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c]
    return s


def _impurity_cost(left: torch.Tensor, right: torch.Tensor,
                   kind: str) -> torch.Tensor:
    """Weighted impurity of a (left, right) class-count split, in the
    reference's order of f32 operations. left/right: [..., C] counts.
    Returns [...] cost; +inf where a side is empty (an invalid split,
    MLlib's minInstancesPerNode=1)."""
    nl = _sum_classes(left)
    nr = _sum_classes(right)
    n = nl + nr

    def node_impurity(counts, total):
        p = counts / torch.clamp(total, min=1.0)[..., None]
        if kind == "entropy":
            return -_sum_classes(torch.where(p > 0, p * torch.log(p),
                                             torch.zeros_like(p)))
        return 1.0 - _sum_classes(p * p)          # gini

    cost = (nl * node_impurity(left, nl) +
            nr * node_impurity(right, nr)) / torch.clamp(n, min=1.0)
    return torch.where((nl == 0) | (nr == 0),
                       torch.full_like(cost, float("inf")), cost)


def _level_histogram(xq: torch.Tensor, y: torch.Tensor, boot: torch.Tensor,
                     node: torch.Tensor, width: int, n_bins: int,
                     n_classes: int) -> torch.Tensor:
    """[T, width, F, B, C] int64 class counts of one level: the bagged
    samples of every tree by (node, feature, bin, class)."""
    t_all, n = boot.shape
    f = xq.shape[1]
    cells = t_all * width * f * n_bins * n_classes
    idx_dtype = torch.int32 if cells < (1 << 31) else torch.int64
    hist = torch.zeros(cells, dtype=torch.int64, device=xq.device)
    per_tree = max(1, HIST_ELEMENTS // max(1, n * f))
    feats = torch.arange(f, dtype=idx_dtype, device=xq.device)
    for t0 in range(0, t_all, per_tree):
        t1 = min(t_all, t0 + per_tree)
        rows = boot[t0:t1]                                  # [t, N]
        trees = torch.arange(t0, t1, dtype=idx_dtype,
                             device=xq.device)[:, None]
        base = (trees * width + node[t0:t1].to(idx_dtype)) * f
        cell = base[:, :, None] + feats                     # [t, N, F]
        cell.mul_(n_bins).add_(xq[rows])
        cell.mul_(n_classes).add_(y[rows].to(idx_dtype)[:, :, None])
        hist += torch.bincount(cell.reshape(-1), minlength=cells)
    return hist.view(t_all, width, f, n_bins, n_classes)


def _fit_forest(xq: torch.Tensor, y: torch.Tensor, boot: torch.Tensor,
                feat_mask: torch.Tensor, n_classes: int, max_depth: int,
                max_bins: int, impurity: str, timings: Optional[list] = None):
    """All trees' fit on the tensors' device.

    xq        [N, F] quantile-bin codes (uint8 or int32)
    y         [N] int64 class codes
    boot      [T, N] int64 bootstrap sample indices, one bag a tree
    feat_mask [T, 2^max_depth - 1, F] bool: allowed features per node
    Returns (feat [T, M], thr [T, M], leaf [T, 2^max_depth]) int64 with
    M = 2^max_depth - 1 internal nodes in breadth-first order.
    ``timings``, when given, receives each level's histogram seconds
    (the device synchronised around it)."""
    dev = xq.device
    t_all, n = boot.shape
    f, b, c = xq.shape[1], max_bins, n_classes
    m = 2 ** max_depth - 1
    feat_out = torch.zeros((t_all, m), dtype=torch.int64, device=dev)
    thr_out = torch.full((t_all, m), b - 1, dtype=torch.int64, device=dev)
    node = torch.zeros((t_all, n), dtype=torch.int64, device=dev)
    inf = float("inf")
    for d in range(max_depth):
        width = 2 ** d
        base = width - 1
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        hist = _level_histogram(xq, y, boot, node, width, b, c)
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings.append(time.perf_counter() - t0)
        # threshold t sends bin <= t left: left counts = cumsum over bins
        left = torch.cumsum(hist, dim=3).to(torch.float32)  # [T,w,F,B,C]
        total = left[:, :, :, -1:, :]
        right = total - left
        cost = _impurity_cost(left, right, impurity)        # [T,w,F,B]
        # the last bin (everything left) is the no-op sentinel: +inf;
        # features outside the node's mask: +inf
        cost[..., -1] = inf
        mask = feat_mask[:, base:base + width]              # [T, w, F]
        cost = torch.where(mask[..., None], cost,
                           torch.full_like(cost, inf))
        flat = cost.reshape(t_all, width, f * b)
        best = torch.argmin(flat, dim=2)                    # first minimum
        best_cost = torch.gather(flat, 2, best[..., None])[..., 0]
        ok = torch.isfinite(best_cost)
        bf = torch.where(ok, best // b, torch.zeros_like(best))
        bt = torch.where(ok, best % b, torch.full_like(best, b - 1))
        feat_out[:, base:base + width] = bf
        thr_out[:, base:base + width] = bt
        # route the bagged samples
        nf = torch.gather(bf, 1, node)                      # [T, N]
        nt = torch.gather(bt, 1, node)
        go_right = xq[boot, nf] > nt
        node = node * 2 + go_right.to(torch.int64)
    # leaves: the majority class of the last level's bagged samples
    width = 2 ** max_depth
    trees = torch.arange(t_all, device=dev)[:, None]
    cell = (trees * width + node) * c + y[boot]
    leaf_hist = torch.bincount(cell.reshape(-1),
                               minlength=t_all * width * c)
    leaf = torch.argmax(leaf_hist.view(t_all, width, c), dim=2)
    return feat_out, thr_out, leaf


def _predict_codes(feat: torch.Tensor, thr: torch.Tensor, leaf: torch.Tensor,
                   qbins: torch.Tensor, max_depth: int,
                   n_classes: int) -> torch.Tensor:
    """feat/thr [T, M], leaf [T, 2^D], qbins [N, F] -> [N] class codes:
    all trees walked in lockstep, then the majority vote (ties to the
    lowest class code)."""
    t_all = feat.shape[0]
    n = qbins.shape[0]
    node = torch.zeros((t_all, n), dtype=torch.int64, device=qbins.device)
    cols = torch.arange(n, device=qbins.device)[None, :]
    for d in range(max_depth):
        idx = (2 ** d - 1) + node
        nf = torch.gather(feat, 1, idx)                     # [T, N]
        nt = torch.gather(thr, 1, idx)
        node = node * 2 + (qbins[cols, nf] > nt).to(torch.int64)
    pred = torch.gather(leaf, 1, node)                      # [T, N]
    votes = torch.bincount((cols * n_classes + pred).reshape(-1),
                           minlength=n * n_classes).view(n, n_classes)
    return torch.argmax(votes, dim=1)


@dataclasses.dataclass(eq=False)
class ForestModel:
    """A forest as plain arrays: bin thresholds + per-tree node arrays."""

    classes: np.ndarray          # [C] original labels
    thresholds: np.ndarray       # [F, B-1] float32 quantile cut points
    feat: np.ndarray             # [T, 2^D - 1] int32
    thr: np.ndarray              # [T, 2^D - 1] int32 (bin index)
    leaf: np.ndarray             # [T, 2^D] int32 class codes
    max_depth: int
    #: where predict walks the trees (None: ``cuda``)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self._dev = None    # (thresholds, feat, thr, leaf) on the device

    def _on_device(self):
        if self._dev is None:
            dev = resolve_device(self.device)
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (self.thresholds.astype(np.float32),
                          self.feat.astype(np.int64),
                          self.thr.astype(np.int64),
                          self.leaf.astype(np.int64)))
        return self._dev

    def binize(self, X: np.ndarray) -> np.ndarray:
        """Host quantile-bin codes of X (the reference's ``_binize``)."""
        return _binize(self.thresholds, X)

    def predict_codes(self, X: np.ndarray) -> np.ndarray:
        """[N, F] -> [N] class codes, binned and voted on the device."""
        thresholds, feat, thr, leaf = self._on_device()
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(X, np.float32).T)).to(thresholds.device)
        # searchsorted(side="left") per feature row, as np.searchsorted
        qbins = torch.searchsorted(thresholds, x, side="left").T
        return _predict_codes(feat, thr, leaf, qbins, self.max_depth,
                              len(self.classes)).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        """[N, F] -> [N] predicted labels (majority vote)."""
        return self.classes[self.predict_codes(np.atleast_2d(X))]

    def device_bytes(self) -> int:
        """Bytes of the thresholds and node arrays on the device."""
        if self._dev is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._dev)

    def release_device(self) -> None:
        self._dev = None


def _binize(thresholds: np.ndarray, X: np.ndarray) -> np.ndarray:
    """[N, F] int32 bin codes: per feature, the first cut point >= x."""
    xq = np.empty(X.shape, np.int32)
    for j in range(X.shape[1]):
        xq[:, j] = np.searchsorted(thresholds[j], X[:, j], side="left")
    return xq


def bin_features(X: np.ndarray, max_bins: int):
    """MLlib's findSplits analog: ``(thresholds [F, B-1] f32, xq [N, F]
    int32)``, B-1 interior quantile cut points per feature."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    thresholds = np.quantile(X, qs, axis=0).T.astype(np.float32)
    return thresholds, _binize(thresholds, X)


def draw_bags(n: int, n_features: int, params: ForestParams):
    """The reference's RNG stream: ``(boot [T, N] int32, mask [T, M, F]
    bool)``, bootstrap indices then per-(tree, node) feature subsets."""
    t_req = int(params.num_trees)
    rng = np.random.default_rng(params.seed)
    boot = rng.integers(0, n, size=(t_req, n)).astype(np.int32)
    m = _subset_size(params.feature_subset_strategy, n_features)
    n_nodes = 2 ** int(params.max_depth) - 1
    if m >= n_features:
        mask = np.ones((t_req, n_nodes, n_features), bool)
    else:
        scores = rng.random((t_req, n_nodes, n_features))
        kth = np.partition(scores, m - 1, axis=-1)[..., m - 1:m]
        mask = scores <= kth
    return boot, mask


def train_forest(X: np.ndarray, y: Sequence, params: ForestParams,
                 mesh=None, device=None,
                 timings: Optional[list] = None) -> ForestModel:
    """Fit a forest on dense [N, F] features with arbitrary labels, on
    ``device`` (``cuda`` unless the caller asks for the CPU); the model
    predicts there too. With a ``mesh`` of more than one position the
    trees shard over its first axis (the module docstring) and the model
    predicts on the first local device. ``timings`` receives each
    level's histogram seconds (each local position's, in turn)."""
    on_mesh = mesh is not None and mesh.size > 1
    dev = mesh.local_devices()[0] if on_mesh else resolve_device(device)
    X = np.asarray(X, np.float32)
    classes, codes = np.unique(np.asarray(y), return_inverse=True)
    c = int(params.num_classes) or len(classes)
    if c < len(classes):
        raise ValueError(f"numClasses={c} but labels have {len(classes)}")
    b = int(params.max_bins)
    thresholds, xq = bin_features(X, b)
    boot, mask = draw_bags(X.shape[0], X.shape[1], params)
    depth = int(params.max_depth)
    xq = xq.astype(np.uint8 if b <= 256 else np.int32)
    codes = codes.reshape(-1).astype(np.int64)

    def fit(on, trees: slice):
        return _fit_forest(
            torch.from_numpy(xq).to(on), torch.from_numpy(codes).to(on),
            torch.from_numpy(boot[trees].astype(np.int64)).to(on),
            torch.from_numpy(mask[trees]).to(on), c, depth, b,
            params.impurity, timings=timings)

    if on_mesh:
        feat, thr, leaf = _fit_on_mesh(fit, len(boot), mesh)
    else:
        feat, thr, leaf = fit(dev, slice(None))
    return ForestModel(
        classes=classes, thresholds=thresholds,
        feat=feat.cpu().numpy().astype(np.int32),
        thr=thr.cpu().numpy().astype(np.int32),
        leaf=leaf.cpu().numpy().astype(np.int32), max_depth=depth,
        device=dev)


def _fit_on_mesh(fit, t_req: int, mesh):
    """``(feat, thr, leaf)`` of ``t_req`` trees sharded over the mesh's
    first axis: ``fit(device, trees)`` grows a run of trees (indices past
    ``t_req`` are copies of tree 0, sliced off after the gather)."""
    from predictionio_tpu_torch.parallel.collectives import all_gather

    axis = mesh.axis_names[0]
    per = -(-t_req // mesh.shape[axis])
    parts = []
    for p, dev in zip(mesh.local_positions(), mesh.local_devices()):
        lo = mesh.axis_index(p, axis) * per
        ids = [i if i < t_req else 0 for i in range(lo, lo + per)]
        feat, thr, leaf = fit(dev, ids)
        parts.append(torch.cat([feat, thr, leaf], dim=1))
    nodes = all_gather(parts, mesh, axis)[0][:t_req]
    m = (nodes.shape[1] - 1) // 3       # 2^D - 1 nodes, 2^D leaves
    return nodes.split([m, m, m + 1], dim=1)

