"""Evaluation metrics (a numpy copy of ``clap2diffusion_tpu/eval/metrics.py``:
the port imports nothing of the JAX package, so a fix to the original must
be copied here).

The reference's evaluator returns random numbers for every metric
(reference scripts/evaluate.py:32-40). Here the metric *math* is real:

- ``audio_text_alignment``: cosine similarity of CLAP audio/text embeddings —
  fully real with our towers (reference models/audio_encoder.py:287-309).
- ``frechet_distance``: exact Frechet/FID math over any feature set; the
  feature extractor is pluggable (InceptionV3 weights are not available in
  this offline image, so FID-vs-reference uses whatever embedding net is
  supplied — CLAP/CLIP features by default).
- ``clip_score``: cosine between image features and text features for a
  supplied image encoder (the CLIP vision tower converts via
  models/convert.py conventions when weights are present).
- ``inception_score``: standard IS math over pluggable class probabilities.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def audio_text_alignment(audio_emb: np.ndarray, text_emb: np.ndarray) -> float:
    """Mean cosine similarity between L2-normalized CLAP embeddings."""
    a = audio_emb / (np.linalg.norm(audio_emb, axis=-1, keepdims=True) + 1e-8)
    t = text_emb / (np.linalg.norm(text_emb, axis=-1, keepdims=True) + 1e-8)
    return float((a * t).sum(-1).mean())


def clip_score(image_features: np.ndarray, text_features: np.ndarray,
               scale: float = 100.0) -> float:
    """max(0, 100 * cos(image, text)), batch mean (standard CLIPScore)."""
    i = image_features / (np.linalg.norm(image_features, axis=-1, keepdims=True) + 1e-8)
    t = text_features / (np.linalg.norm(text_features, axis=-1, keepdims=True) + 1e-8)
    return float(np.maximum((i * t).sum(-1) * scale, 0.0).mean())


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """Frechet distance between Gaussians fit to two feature sets [N, D].

    ||mu_a - mu_b||^2 + Tr(Ca + Cb - 2 (Ca Cb)^(1/2)); the matrix sqrt is
    computed via eigendecomposition of the symmetrized product.
    """
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    ca = np.cov(feats_a, rowvar=False) + eps * np.eye(feats_a.shape[1])
    cb = np.cov(feats_b, rowvar=False) + eps * np.eye(feats_b.shape[1])
    diff = mu_a - mu_b

    # sqrt(Ca Cb) via sqrt(Ca) Cb sqrt(Ca) (symmetric PSD path)
    wa, va = np.linalg.eigh(ca)
    sqrt_ca = (va * np.sqrt(np.maximum(wa, 0))) @ va.T
    m = sqrt_ca @ cb @ sqrt_ca
    wm = np.linalg.eigvalsh((m + m.T) / 2)
    tr_sqrt = np.sqrt(np.maximum(wm, 0)).sum()
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2 * tr_sqrt)


def inception_score(probs: np.ndarray, splits: int = 10) -> Dict[str, float]:
    """IS over class probabilities [N, C]: exp(E KL(p(y|x) || p(y)))."""
    n = probs.shape[0]
    scores = []
    for part in np.array_split(probs, min(splits, n)):
        py = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-10) - np.log(py + 1e-10))).sum(-1)
        scores.append(float(np.exp(kl.mean())))
    return {"mean": float(np.mean(scores)), "std": float(np.std(scores))}


def image_stats(images: np.ndarray) -> Dict[str, float]:
    """Cheap sanity metrics over uint8 images [N, H, W, 3]."""
    x = images.astype(np.float32) / 255.0
    return {
        "mean": float(x.mean()),
        "std": float(x.std()),
        "inter_image_l2": float(
            np.linalg.norm(x.reshape(len(x), -1) - x.reshape(len(x), -1).mean(0), axis=1).mean()
        ),
    }


def summarize(per_sample: Dict[str, list]) -> Dict[str, Dict[str, float]]:
    """mean +/- std summary, mirroring the reference's results JSON
    (reference scripts/evaluate.py:117-131)."""
    out = {}
    for k, vals in per_sample.items():
        arr = np.asarray(vals, np.float64)
        out[k] = {"mean": float(arr.mean()), "std": float(arr.std())}
    return out


def polynomial_mmd2(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Unbiased MMD^2 with the cubic polynomial kernel
    k(x, y) = (x.y / d + 1)^3 (Binkowski et al. 2018, "Demystifying MMD
    GANs" — the KID kernel). Unbiased: diagonal terms excluded, so the
    estimate can be slightly negative when the two sets share a
    distribution."""
    m, d = feats_a.shape
    n = feats_b.shape[0]
    if m < 2 or n < 2:
        raise ValueError(f"need >=2 samples per set, got {m} and {n}")
    a = feats_a.astype(np.float64)
    b = feats_b.astype(np.float64)
    kaa = (a @ a.T / d + 1.0) ** 3
    kbb = (b @ b.T / d + 1.0) ** 3
    kab = (a @ b.T / d + 1.0) ** 3
    sum_aa = (kaa.sum() - np.trace(kaa)) / (m * (m - 1))
    sum_bb = (kbb.sum() - np.trace(kbb)) / (n * (n - 1))
    return float(sum_aa + sum_bb - 2.0 * kab.mean())


def kid_from_features(feats_a: np.ndarray, feats_b: np.ndarray,
                      n_subsets: int = 10,
                      subset_size: int | None = None,
                      seed: int = 42) -> Dict[str, float]:
    """Kernel Inception Distance: mean +/- std of unbiased polynomial-MMD^2
    over random subsets (the block estimator of Binkowski et al. 2018).

    Complements FID at the evaluator's small sample counts (8-64): the
    Frechet estimator is strongly biased at small N (it fits a 2048-dim
    Gaussian), while MMD^2_u is unbiased at any N. Same naming contract as
    ``fid_from_images``: "KID" proper means InceptionV3 pool3 features; the
    math is extractor-agnostic.
    """
    m = min(len(feats_a), len(feats_b))
    size = min(subset_size or min(m, 1000), m)
    if size >= len(feats_a) and size >= len(feats_b):
        # subsets would all be the full sets — one exact pass
        return {"mean": polynomial_mmd2(feats_a, feats_b), "std": 0.0}
    rng = np.random.RandomState(seed)
    vals = []
    for _ in range(max(1, n_subsets)):
        ia = rng.choice(len(feats_a), size, replace=False)
        ib = rng.choice(len(feats_b), size, replace=False)
        vals.append(polynomial_mmd2(feats_a[ia], feats_b[ib]))
    return {"mean": float(np.mean(vals)), "std": float(np.std(vals))}


def fid_from_images(images_a: np.ndarray, images_b: np.ndarray,
                    feature_fn: Callable[[np.ndarray], np.ndarray],
                    batch_size: int = 16) -> float:
    """Frechet distance between two uint8 image sets using a pluggable
    feature extractor.

    NAMING CONTRACT: this is *standard FID* only when ``feature_fn`` is
    InceptionV3 pool3 (2048-d) — the extractor the literature and the
    reference's declared ``fid_score`` (reference scripts/evaluate.py:24-30)
    assume. The in-repo extractor is ``models/inception_v3.py`` (the tower
    + torchvision-state-dict converter); the evaluator reports ``fid`` when
    those weights are loaded (``tools/convert_checkpoints.py --inception``)
    and falls back to ``frechet_clip_vision`` (CLIP ViT features — NOT
    comparable with published FID numbers) otherwise. The Frechet math
    below is extractor-agnostic and exact either way.
    """

    return frechet_distance(
        batched_features(images_a, feature_fn, batch_size),
        batched_features(images_b, feature_fn, batch_size),
    )


def batched_features(images: np.ndarray,
                     feature_fn: Callable[[np.ndarray], np.ndarray],
                     batch_size: int = 16) -> np.ndarray:
    """Apply ``feature_fn`` in fixed-size batches, padding the tail chunk by
    repeating its last image (features are per-image, so padding is sliced
    back off exactly). The pad keeps every chunk at one shape, as the JAX
    package keeps every chunk on one compiled program."""
    out = []
    for i in range(0, len(images), batch_size):
        chunk = images[i : i + batch_size]
        k = len(chunk)
        if k < batch_size:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - k, axis=0)]
            )
        out.append(np.asarray(feature_fn(chunk))[:k])
    return np.concatenate(out, axis=0)
