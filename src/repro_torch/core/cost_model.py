"""ML resource estimator (paper Sec 3.5): GBT pipeline vs MLP baseline.

Pipeline (Fig. 10):  raw features -> degree-2 polynomial combinations ->
gradient-boosted regression trees -> importance-based re-selection of the
top-36 generated features -> refit.  The baseline is the MLP of [19]
(Koeplinger et al., ISCA'16), grid-tuned as the paper describes.

Everything is pure numpy (no sklearn/xgboost in this container): shallow
regression trees split on quantile thresholds by variance reduction;
boosting is least-squares with shrinkage and row subsampling; the MLP is a
two-hidden-layer ReLU net trained with Adam + early stopping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .features import extract_features, poly2_expand

# ---------------------------------------------------------------------------
# Regression tree (depth-limited, quantile-threshold splits)
# ---------------------------------------------------------------------------


@dataclass
class _TreeNode:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_TreeNode"] = None
    right: Optional["_TreeNode"] = None
    value: float = 0.0

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    def to_json(self) -> dict:
        if self.is_leaf:
            return {"v": self.value}
        return {"f": self.feature, "t": self.threshold,
                "l": self.left.to_json(), "r": self.right.to_json()}

    @staticmethod
    def from_json(d: dict) -> "_TreeNode":
        if "f" not in d:
            return _TreeNode(value=d["v"])
        return _TreeNode(feature=d["f"], threshold=d["t"],
                         left=_TreeNode.from_json(d["l"]),
                         right=_TreeNode.from_json(d["r"]))


def _fit_tree(X, y, depth, min_leaf, rng, n_thresholds=16, feature_frac=0.8):
    node = _TreeNode(value=float(y.mean()))
    if depth == 0 or len(y) < 2 * min_leaf or float(y.var()) < 1e-12:
        return node
    n, d = X.shape
    feats = rng.choice(d, size=max(1, int(d * feature_frac)), replace=False)
    best = (0.0, -1, 0.0)  # (gain, feature, threshold)
    base_sse = float(((y - y.mean()) ** 2).sum())
    for f in feats:
        col = X[:, f]
        qs = np.unique(np.quantile(col, np.linspace(0.05, 0.95, n_thresholds)))
        for t in qs:
            mask = col <= t
            nl = int(mask.sum())
            if nl < min_leaf or n - nl < min_leaf:
                continue
            yl, yr = y[mask], y[~mask]
            sse = float(((yl - yl.mean()) ** 2).sum() + ((yr - yr.mean()) ** 2).sum())
            gain = base_sse - sse
            if gain > best[0]:
                best = (gain, int(f), float(t))
    if best[1] < 0:
        return node
    _, f, t = best
    mask = X[:, f] <= t
    node.feature, node.threshold = f, t
    node.left = _fit_tree(X[mask], y[mask], depth - 1, min_leaf, rng,
                          n_thresholds, feature_frac)
    node.right = _fit_tree(X[~mask], y[~mask], depth - 1, min_leaf, rng,
                           n_thresholds, feature_frac)
    return node


def _tree_predict(node: _TreeNode, X: np.ndarray) -> np.ndarray:
    if node.is_leaf:
        return np.full(len(X), node.value)
    mask = X[:, node.feature] <= node.threshold
    out = np.empty(len(X))
    out[mask] = _tree_predict(node.left, X[mask])
    out[~mask] = _tree_predict(node.right, X[~mask])
    return out


def _tree_importance(node: _TreeNode, imp: np.ndarray) -> None:
    if node.is_leaf:
        return
    imp[node.feature] += 1.0  # split frequency (paper's definition)
    _tree_importance(node.left, imp)
    _tree_importance(node.right, imp)


# ---------------------------------------------------------------------------
# Gradient boosting
# ---------------------------------------------------------------------------


@dataclass
class GradientBoostedTrees:
    n_estimators: int = 150
    max_depth: int = 3
    learning_rate: float = 0.08
    subsample: float = 0.8
    min_leaf: int = 3
    seed: int = 0

    trees: List[_TreeNode] = field(default_factory=list)
    base: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoostedTrees":
        rng = np.random.default_rng(self.seed)
        self.base = float(y.mean())
        pred = np.full(len(y), self.base)
        self.trees = []
        for _ in range(self.n_estimators):
            resid = y - pred
            idx = rng.choice(len(y), size=max(2, int(len(y) * self.subsample)),
                             replace=False)
            tree = _fit_tree(X[idx], resid[idx], self.max_depth,
                             self.min_leaf, rng)
            self.trees.append(tree)
            pred = pred + self.learning_rate * _tree_predict(tree, X)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        pred = np.full(len(X), self.base)
        for t in self.trees:
            pred = pred + self.learning_rate * _tree_predict(t, X)
        return pred

    def feature_importance(self, d: int) -> np.ndarray:
        imp = np.zeros(d)
        for t in self.trees:
            _tree_importance(t, imp)
        return imp

    def to_json(self) -> dict:
        return {
            "params": dict(n_estimators=self.n_estimators,
                           max_depth=self.max_depth,
                           learning_rate=self.learning_rate,
                           subsample=self.subsample,
                           min_leaf=self.min_leaf, seed=self.seed),
            "base": self.base,
            "trees": [t.to_json() for t in self.trees],
        }

    @staticmethod
    def from_json(d: dict) -> "GradientBoostedTrees":
        gbt = GradientBoostedTrees(**d["params"])
        gbt.base = d["base"]
        gbt.trees = [_TreeNode.from_json(t) for t in d["trees"]]
        return gbt


# ---------------------------------------------------------------------------
# The paper's full pipeline: poly2 -> GBT -> top-36 reselect -> refit
# ---------------------------------------------------------------------------


@dataclass
class ResourcePipeline:
    n_selected: int = 36  # paper: 36 generated features suffice
    gbt_params: dict = field(default_factory=dict)

    mu: np.ndarray = None
    sd: np.ndarray = None
    selected: np.ndarray = None
    model: GradientBoostedTrees = None
    names: List[str] = field(default_factory=list)
    log_target: bool = True

    def _prep(self, Xraw: np.ndarray) -> Tuple[np.ndarray, List[str]]:
        Xp, names = poly2_expand(Xraw)
        return Xp, names

    def fit(self, Xraw: np.ndarray, y: np.ndarray) -> "ResourcePipeline":
        Xp, names = self._prep(Xraw)
        self.mu, self.sd = Xp.mean(0), Xp.std(0) + 1e-9
        Xs = (Xp - self.mu) / self.sd
        yt = np.log1p(np.maximum(y, 0)) if self.log_target else y
        stage1 = GradientBoostedTrees(**{**dict(seed=1), **self.gbt_params}).fit(Xs, yt)
        imp = stage1.feature_importance(Xs.shape[1])
        k = min(self.n_selected, Xs.shape[1])
        self.selected = np.argsort(-imp)[:k]
        self.names = [names[i] for i in self.selected]
        self.model = GradientBoostedTrees(**{**dict(seed=2), **self.gbt_params})
        self.model.fit(Xs[:, self.selected], yt)
        return self

    def predict(self, Xraw: np.ndarray) -> np.ndarray:
        Xp, _ = self._prep(Xraw)
        Xs = (Xp - self.mu) / self.sd
        p = self.model.predict(Xs[:, self.selected])
        return np.expm1(p) if self.log_target else p

    def to_json(self) -> dict:
        return {
            "n_selected": self.n_selected,
            "gbt_params": dict(self.gbt_params),
            "mu": self.mu.tolist(),
            "sd": self.sd.tolist(),
            "selected": np.asarray(self.selected).tolist(),
            "names": list(self.names),
            "log_target": self.log_target,
            "model": self.model.to_json(),
        }

    @staticmethod
    def from_json(d: dict) -> "ResourcePipeline":
        pipe = ResourcePipeline(n_selected=d["n_selected"],
                                gbt_params=dict(d["gbt_params"]))
        pipe.mu = np.asarray(d["mu"])
        pipe.sd = np.asarray(d["sd"])
        pipe.selected = np.asarray(d["selected"], dtype=np.int64)
        pipe.names = list(d["names"])
        pipe.log_target = d["log_target"]
        pipe.model = GradientBoostedTrees.from_json(d["model"])
        return pipe


# ---------------------------------------------------------------------------
# MLP baseline ([19]-style, as tuned in the paper's comparison)
# ---------------------------------------------------------------------------


@dataclass
class MLPBaseline:
    hidden: Tuple[int, int] = (64, 32)
    lr: float = 1e-3
    epochs: int = 400
    l2: float = 1e-4
    seed: int = 0
    log_target: bool = True

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MLPBaseline":
        rng = np.random.default_rng(self.seed)
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-9
        Xs = (X - self.mu) / self.sd
        yt = np.log1p(np.maximum(y, 0)) if self.log_target else y
        ymu, ysd = yt.mean(), yt.std() + 1e-9
        self.ymu, self.ysd = ymu, ysd
        yn = (yt - ymu) / ysd
        d = X.shape[1]
        h1, h2 = self.hidden
        params = {
            "W1": rng.normal(0, np.sqrt(2 / d), (d, h1)), "b1": np.zeros(h1),
            "W2": rng.normal(0, np.sqrt(2 / h1), (h1, h2)), "b2": np.zeros(h2),
            "W3": rng.normal(0, np.sqrt(2 / h2), (h2, 1)), "b3": np.zeros(1),
        }
        m = {k: np.zeros_like(v) for k, v in params.items()}
        v = {k: np.zeros_like(v_) for k, v_ in params.items()}
        t = 0
        n = len(Xs)
        for epoch in range(self.epochs):
            idx = rng.permutation(n)
            for start in range(0, n, 32):
                b = idx[start:start + 32]
                xb, yb = Xs[b], yn[b]
                # forward
                z1 = xb @ params["W1"] + params["b1"]; a1 = np.maximum(z1, 0)
                z2 = a1 @ params["W2"] + params["b2"]; a2 = np.maximum(z2, 0)
                out = (a2 @ params["W3"] + params["b3"]).ravel()
                g_out = 2 * (out - yb)[:, None] / len(b)
                grads = {}
                grads["W3"] = a2.T @ g_out + self.l2 * params["W3"]
                grads["b3"] = g_out.sum(0)
                g2 = (g_out @ params["W3"].T) * (z2 > 0)
                grads["W2"] = a1.T @ g2 + self.l2 * params["W2"]
                grads["b2"] = g2.sum(0)
                g1 = (g2 @ params["W2"].T) * (z1 > 0)
                grads["W1"] = xb.T @ g1 + self.l2 * params["W1"]
                grads["b1"] = g1.sum(0)
                t += 1
                for k in params:
                    m[k] = 0.9 * m[k] + 0.1 * grads[k]
                    v[k] = 0.999 * v[k] + 0.001 * grads[k] ** 2
                    mh = m[k] / (1 - 0.9 ** t)
                    vh = v[k] / (1 - 0.999 ** t)
                    params[k] -= self.lr * mh / (np.sqrt(vh) + 1e-8)
        self.params = params
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xs = (X - self.mu) / self.sd
        a1 = np.maximum(Xs @ self.params["W1"] + self.params["b1"], 0)
        a2 = np.maximum(a1 @ self.params["W2"] + self.params["b2"], 0)
        out = (a2 @ self.params["W3"] + self.params["b3"]).ravel()
        yt = out * self.ysd + self.ymu
        return np.expm1(yt) if self.log_target else yt


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum()) + 1e-12
    return 1.0 - ss_res / ss_tot


# ---------------------------------------------------------------------------
# Scorer adapter for the solver (rank_solutions hook)
# ---------------------------------------------------------------------------


class MLScorer:
    """Wraps per-resource pipelines into a scalar scheme-ranking score."""

    def __init__(self, pipelines: dict, weights=None):
        self.pipelines = pipelines  # {"lut": ResourcePipeline, ...}
        self.weights = weights or {"lut": 1.0, "ff": 0.4, "bram": 200.0,
                                   "dsp": 400.0}

    def __call__(self, sol) -> float:
        x = extract_features(sol)[None, :]
        score = 0.0
        for res, pipe in self.pipelines.items():
            score += self.weights.get(res, 1.0) * float(pipe.predict(x)[0])
        return score

    def with_pipeline(self, name: str, pipeline,
                      weight: float = 1.0) -> "MLScorer":
        """A copy with one pipeline added/replaced -- how the telemetry
        refresh grafts a measured-latency resource onto the static model
        without mutating the shared instance."""
        pipes = dict(self.pipelines)
        pipes[name] = pipeline
        weights = dict(self.weights)
        weights[name] = float(weight)
        return MLScorer(pipes, weights=weights)

    def to_json(self) -> dict:
        return {
            "format": "ml-scorer/v1",
            "weights": dict(self.weights),
            "pipelines": {k: p.to_json() for k, p in self.pipelines.items()},
        }

    @staticmethod
    def from_json(d: dict) -> "MLScorer":
        if d.get("format") != "ml-scorer/v1":
            raise ValueError(f"not an ml scorer: format={d.get('format')!r}")
        pipes = {k: ResourcePipeline.from_json(p)
                 for k, p in d["pipelines"].items()}
        return MLScorer(pipes, weights=dict(d["weights"]))
