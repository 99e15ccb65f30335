"""Benchmark dataset loaders: real ANN corpora when available, faithful synthesis otherwise.

The ann-benchmarks corpora SIFT-1M (128-d image descriptors), GloVe-1.2M (100-d word
embeddings, cosine) and DEEP (96-d CNN descriptors).  This module loads the real thing
when a copy exists locally (or can be fetched), because IVF recall and filtered-search
selectivity are only meaningful on realistically distributed data — and
otherwise synthesizes a corpus with the documented large-scale statistics of each dataset
(anisotropic clustered mixtures, heavy-tailed cluster sizes, norm distribution), clearly
labeling the result so numbers are never silently mislabeled as "real".

Search order per dataset:
  1. $MLVDB_DATASETS/<name>/ (pre-downloaded .fvecs/.npy files)
  2. ./datasets/<name>/
  3. HTTP fetch (ftp.irisa.fr / ann-benchmarks mirrors) — skipped in zero-egress
     environments (any network failure falls through)
  4. synthesize_<family>() fallback

Returned record: dict(name, kind="real"|"synthetic", data [N,D] f32, queries [Q,D] f32,
metric, groundtruth [Q,k] int64 or None).
"""

from __future__ import annotations

import os
import sys
import tarfile
import urllib.request
from typing import Dict, Optional

import numpy as np


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _search_dirs(name: str):
    env = os.environ.get("MLVDB_DATASETS")
    if env:
        yield os.path.join(env, name)
    yield os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets", name)


def read_fvecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Read the TEXMEX .fvecs format: per row an int32 dim then dim float32s."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)[:, 1:]
    if limit is not None:
        rows = rows[:limit]
    return rows.view(np.float32).copy()


def read_ivecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    d = int(raw[0])
    rows = raw.reshape(-1, d + 1)[:, 1:]
    if limit is not None:
        rows = rows[:limit]
    return rows.astype(np.int64)


def _try_fetch(url: str, dest: str, max_bytes: int = 2 << 30) -> bool:
    try:
        _log(f"fetching {url} ...")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with urllib.request.urlopen(url, timeout=30) as r, open(dest + ".part", "wb") as f:
            n = 0
            while True:
                chunk = r.read(1 << 22)
                if not chunk:
                    break
                n += len(chunk)
                if n > max_bytes:
                    raise IOError("download exceeds size cap")
                f.write(chunk)
        os.rename(dest + ".part", dest)
        return True
    except Exception as e:  # zero-egress / mirror down: fall through to synthesis
        _log(f"fetch failed ({e}); falling back")
        return False


# --------------------------------------------------------------------------- synthesis

def synthesize_clustered(
    n: int,
    dim: int,
    n_queries: int,
    *,
    n_clusters: int,
    within_scale: float,
    anisotropy: float = 4.0,
    zipf_s: float = 1.2,
    normalize: bool = False,
    seed: int = 7,
) -> Dict[str, np.ndarray]:
    """Anisotropic Gaussian-mixture corpus with heavy-tailed (Zipf) cluster sizes.

    This mirrors the population statistics that make real embedding corpora hard for
    IVF (uneven cluster mass, stretched local covariance) and easy for nothing: queries
    are drawn as perturbations of held-out corpus points — the standard
    query-near-the-manifold regime of SIFT/GloVe evaluation.
    """
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    # per-cluster anisotropic scales (a few stretched directions)
    scales = within_scale * (
        1.0 + (anisotropy - 1.0) * (rng.random((n_clusters, dim)) ** 4)
    ).astype(np.float32)
    # heavy-tailed cluster mass
    w = (1.0 / np.arange(1, n_clusters + 1) ** zipf_s)
    w /= w.sum()
    counts = rng.multinomial(n + n_queries, w)
    rows = np.empty((n + n_queries, dim), np.float32)
    pos = 0
    for c, cnt in enumerate(counts):
        if cnt == 0:
            continue
        rows[pos : pos + cnt] = centers[c] + scales[c] * rng.standard_normal(
            (cnt, dim)
        ).astype(np.float32)
        pos += cnt
    rng.shuffle(rows)
    data, held = rows[:n], rows[n:]
    queries = held + 0.1 * within_scale * rng.standard_normal(held.shape).astype(np.float32)
    if normalize:
        data = data / np.maximum(np.linalg.norm(data, axis=1, keepdims=True), 1e-12)
        queries = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    return {"data": data, "queries": queries}


# --------------------------------------------------------------------------- datasets

def load_sift1m(limit: Optional[int] = None, n_queries: int = 1000) -> Dict:
    """SIFT-1M: 1M x 128-d local image descriptors, l2 (TEXMEX)."""
    for d in _search_dirs("sift1m"):
        base = os.path.join(d, "sift_base.fvecs")
        if os.path.exists(base):
            _log(f"SIFT-1M: real data from {d}")
            gt_path = os.path.join(d, "sift_groundtruth.ivecs")
            return {
                "name": "SIFT-1M",
                "kind": "real",
                "metric": "l2",
                "data": read_fvecs(base, limit),
                "queries": read_fvecs(os.path.join(d, "sift_query.fvecs"), n_queries),
                "groundtruth": read_ivecs(gt_path, n_queries) if os.path.exists(gt_path) and limit is None else None,
            }
    dest_dir = next(_search_dirs("sift1m"))
    tgz = os.path.join(dest_dir, "sift.tar.gz")
    if _try_fetch("ftp://ftp.irisa.fr/local/texmex/corpus/sift.tar.gz", tgz):
        with tarfile.open(tgz) as t:
            t.extractall(dest_dir, filter="data")
        for root, _dirs, files in os.walk(dest_dir):
            if "sift_base.fvecs" in files:
                for f in files:
                    os.replace(os.path.join(root, f), os.path.join(dest_dir, f))
        return load_sift1m(limit, n_queries)
    n = limit or (1 << 20)
    syn = synthesize_clustered(
        n, 128, n_queries, n_clusters=2000, within_scale=0.9, anisotropy=6.0
    )
    _log("SIFT-1M: synthetic fallback (clustered anisotropic mixture)")
    return {"name": "SIFT-1M-synthetic", "kind": "synthetic", "metric": "l2",
            "groundtruth": None, **syn}


def load_glove(limit: Optional[int] = None, n_queries: int = 1000) -> Dict:
    """GloVe-1.2M: ~1.2M x 100-d word embeddings, cosine (ann-benchmarks split)."""
    for d in _search_dirs("glove"):
        base = os.path.join(d, "glove_base.npy")
        if os.path.exists(base):
            _log(f"GloVe: real data from {d}")
            data = np.load(base).astype(np.float32)
            queries = np.load(os.path.join(d, "glove_query.npy")).astype(np.float32)
            return {"name": "GloVe-1.2M", "kind": "real", "metric": "cosine",
                    "data": data[:limit] if limit else data,
                    "queries": queries[:n_queries], "groundtruth": None}
    n = limit or 1_183_514
    syn = synthesize_clustered(
        n, 100, n_queries, n_clusters=1500, within_scale=0.35,
        anisotropy=8.0, normalize=True,
    )
    _log("GloVe: synthetic fallback (normalized clustered mixture)")
    return {"name": "GloVe-synthetic", "kind": "synthetic", "metric": "cosine",
            "groundtruth": None, **syn}


def load_deep(limit: Optional[int] = None, n_queries: int = 1000) -> Dict:
    """DEEP: 96-d CNN descriptors (l2-normalized, so cosine ~ l2)."""
    for d in _search_dirs("deep"):
        base = os.path.join(d, "deep_base.fvecs")
        if os.path.exists(base):
            _log(f"DEEP: real data from {d}")
            return {"name": "DEEP", "kind": "real", "metric": "cosine",
                    "data": read_fvecs(base, limit),
                    "queries": read_fvecs(os.path.join(d, "deep_query.fvecs"), n_queries),
                    "groundtruth": None}
    n = limit or (10 << 20)
    syn = synthesize_clustered(
        n, 96, n_queries, n_clusters=4000, within_scale=0.25,
        anisotropy=5.0, normalize=True,
    )
    _log("DEEP: synthetic fallback (normalized clustered mixture)")
    return {"name": "DEEP-synthetic", "kind": "synthetic", "metric": "cosine",
            "groundtruth": None, **syn}


LOADERS = {"sift1m": load_sift1m, "glove": load_glove, "deep": load_deep}
