"""PCA-based divisive variable clustering, SAS VARCLUS style (the port's
own copy of ``anovos_tpu/data_analyzer/association_eval_varclus.py``).

Only the correlation matrix is computed on the device
(``ops/correlation.py``); everything after it (eigendecompositions of
k×k submatrices, a quartimax rotation, the NCS and search phases) is
float64 numpy on the host, on tiny matrices.  The quartimax rotation is
the gradient-projection algorithm written out.

Algorithm:
1. split the cluster with the largest 2nd eigenvalue (while > maxeigval2);
2. rotate its top-2 eigenvectors (quartimax), assign each variable to the
   rotated component with higher squared correlation (NCS phase);
3. search phase: move single variables between the two clusters while total
   explained variance (sum of first eigenvalues) improves.
Output: [Cluster, Variable, RS_Own, RS_NC, RS_Ratio].
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd


def quartimax_rotate(L: np.ndarray, max_iter: int = 200, tol: float = 1e-8) -> np.ndarray:
    """Orthogonal quartimax rotation via the gradient-projection algorithm
    (maximizes Σ λ_ij⁴ over rotations)."""
    n, k = L.shape
    R = np.eye(k)
    d = 0.0
    for _ in range(max_iter):
        Lr = L @ R
        G = L.T @ (Lr**3)  # quartimax gradient (gamma = 0)
        u, s, vt = np.linalg.svd(G)
        R_new = u @ vt
        d_new = s.sum()
        if d_new < d * (1 + tol):
            R = R_new
            break
        d, R = d_new, R_new
    return L @ R


class VarClus:
    """Divisive clustering over a precomputed correlation matrix."""

    def __init__(
        self,
        corr: pd.DataFrame,
        maxeigval2: float = 1.0,
        maxclus: Optional[int] = None,
        n_rs: int = 0,
        seed: int = 42,
    ):
        self.feat_list = list(corr.columns)
        # integer-indexed view: the reassignment loops evaluate _correig
        # thousands of times, and label-based .loc lookups dominated the
        # whole VarClus wall (pandas indexing ~1.0 s of a 1.5 s fit).
        # .loc re-orders by label so a frame whose index ordering differs
        # from its columns stays correct
        self._C = corr.loc[self.feat_list, self.feat_list].to_numpy()
        self._ix = {f: i for i, f in enumerate(self.feat_list)}
        self.maxeigval2 = maxeigval2
        self.maxclus = maxclus
        self.n_rs = n_rs
        self._rng = np.random.default_rng(seed)
        self.clusters: "collections.OrderedDict[int, dict]" = collections.OrderedDict()

    # -- spectral helpers ------------------------------------------------
    def _sub(self, feats):
        ii = [self._ix[f] for f in feats]
        return self._C[np.ix_(ii, ii)]

    def _row(self, feat, feats):
        return self._C[self._ix[feat]][[self._ix[f] for f in feats]]

    def _correig(self, feats: List[str], n_pcs: int = 2):
        if len(feats) <= 1:
            eigvals = [float(len(feats))] + [0.0] * (n_pcs - 1)
            eigvecs = np.array([[float(len(feats))]])
            varprops = [sum(eigvals)]
            return np.array(eigvals), eigvecs, np.array(varprops)
        corr = self._sub(feats)
        raw_vals, raw_vecs = np.linalg.eigh(corr)
        idx = np.argsort(raw_vals)[::-1]
        vals, vecs = raw_vals[idx], raw_vecs[:, idx]
        varprops = vals[:n_pcs] / max(raw_vals.sum(), 1e-30)
        return vals[:n_pcs], vecs[:, :n_pcs], varprops

    def _tot_var(self, *cluster_lists: List[str]) -> Tuple[float, float]:
        tot_len, tot_var, tot_prop = 0, 0.0, 0.0
        for clus in cluster_lists:
            if not clus:
                continue
            vals, _, props = self._correig(clus)
            tot_var += float(vals[0])
            tot_prop = (tot_prop * tot_len + float(props[0]) * len(clus)) / (tot_len + len(clus))
            tot_len += len(clus)
        return tot_var, tot_prop

    # -- reassignment phases --------------------------------------------
    def _reassign(self, clus1: List[str], clus2: List[str], feats: Optional[List[str]] = None):
        if feats is None:
            feats = clus1 + clus2
        fin1, fin2 = clus1[:], clus2[:]
        check_var = max_var = self._tot_var(clus1, clus2)[0]
        while True:
            for feat in feats:
                n1, n2 = fin1[:], fin2[:]
                if feat in n1:
                    n1.remove(feat)
                    n2.append(feat)
                elif feat in n2:
                    n2.remove(feat)
                    n1.append(feat)
                else:
                    continue
                new_var = self._tot_var(n1, n2)[0]
                if new_var > check_var:
                    check_var = new_var
                    fin1, fin2 = n1, n2
            if max_var == check_var:
                break
            max_var = check_var
        return fin1, fin2, max_var

    def _reassign_rs(self, clus1: List[str], clus2: List[str]):
        feats = clus1 + clus2
        fin1, fin2, best = self._reassign(clus1, clus2)
        for _ in range(self.n_rs):
            self._rng.shuffle(feats)
            c1, c2, v = self._reassign(clus1, clus2, list(feats))
            if v > best:
                best, fin1, fin2 = v, c1, c2
        return fin1, fin2, best

    # -- main loop -------------------------------------------------------
    def fit(self) -> "VarClus":
        vals, vecs, props = self._correig(self.feat_list)
        self.clusters = collections.OrderedDict(
            [
                (
                    0,
                    dict(
                        clus=self.feat_list,
                        eigval1=float(vals[0]),
                        eigval2=float(vals[1]) if len(vals) > 1 else 0.0,
                        eigvecs=vecs,
                        varprop=float(props[0]),
                    ),
                )
            ]
        )
        while True:
            if self.maxclus is not None and len(self.clusters) >= self.maxclus:
                break
            idx = max(self.clusters, key=lambda i: self.clusters[i]["eigval2"])
            if self.clusters[idx]["eigval2"] <= self.maxeigval2:
                break
            split_clus = self.clusters[idx]["clus"]
            c_vals, c_vecs, _ = self._correig(split_clus)
            if not (len(c_vals) > 1 and c_vals[1] > self.maxeigval2):
                break
            # NCS phase: assign to the rotated component with higher |r|
            r_vecs = quartimax_rotate(c_vecs[:, :2])
            corr = self._sub(split_clus)
            comp_cov = corr @ r_vecs  # cov(x_i, comp_j), correlation scale
            comp_var = np.einsum("ij,ij->j", r_vecs, comp_cov)
            sqcorr = (comp_cov**2) / np.maximum(comp_var[None, :], 1e-30)
            clus1 = [f for f, s in zip(split_clus, sqcorr) if s[0] >= s[1]]
            clus2 = [f for f, s in zip(split_clus, sqcorr) if s[0] < s[1]]
            if not clus1 or not clus2:
                break
            fin1, fin2, _ = self._reassign_rs(clus1, clus2)
            if not fin1 or not fin2:
                break
            for new_idx, clus in [(idx, fin1), (max(self.clusters) + 1, fin2)]:
                v, w, p = self._correig(clus)
                self.clusters[new_idx] = dict(
                    clus=clus,
                    eigval1=float(v[0]),
                    eigval2=float(v[1]) if len(v) > 1 else 0.0,
                    eigvecs=w,
                    varprop=float(p[0]),
                )
        return self

    def rsquare_table(self) -> pd.DataFrame:
        """[Cluster, Variable, RS_Own, RS_NC, RS_Ratio] (reference
        _rsquarespark, association_eval_varclus.py:385-451)."""
        comps = {}  # cluster → (feats, first-PC eigvec, comp variance)
        for i, info in self.clusters.items():
            feats = info["clus"]
            if len(feats) == 1:
                comps[i] = (feats, np.array([[1.0]]), 1.0)
                continue
            _, vecs, _ = self._correig(feats)
            v1 = vecs[:, :1]
            corr = self._sub(feats)
            comps[i] = (feats, v1, float((v1.T @ corr @ v1)[0, 0]))
        rows = []
        for i, info in self.clusters.items():
            feats_i, v_i, var_i = comps[i]
            for feat in info["clus"]:
                if len(feats_i) == 1:
                    rs_own = 1.0
                else:
                    cov_own = float(self._row(feat, feats_i) @ v_i[:, 0])
                    rs_own = cov_own**2 / max(var_i, 1e-30)
                rs_others = []
                for k, (feats_k, v_k, var_k) in comps.items():
                    if k == i:
                        continue
                    cov = float(self._row(feat, feats_k) @ v_k[:, 0])
                    denom = var_k if len(feats_k) > 1 else 1.0
                    rs_others.append(cov**2 / max(denom, 1e-30))
                rs_nc = max(rs_others) if rs_others else 0.0
                rows.append(
                    {
                        "Cluster": i,
                        "Variable": feat,
                        "RS_Own": rs_own,
                        "RS_NC": rs_nc,
                        "RS_Ratio": (1 - rs_own) / max(1 - rs_nc, 1e-30),
                    }
                )
        return pd.DataFrame(rows, columns=["Cluster", "Variable", "RS_Own", "RS_NC", "RS_Ratio"])
