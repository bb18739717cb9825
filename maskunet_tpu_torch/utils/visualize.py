"""Visualization: sample and prediction panels (matplotlib, file output).

This package's own copy of maskunet_tpu/utils/visualize.py. Capability
parity with the reference's `visualize_random_sample` and
`visualize_predictions` (ade_semantic.py:104-127, 476-504;
coco_panoptic.py:121-148), saving to files with matplotlib's Agg backend
instead of blocking on plt.show().

matplotlib is imported when a panel is drawn. A host without it (the
H100's host has none) raises `ModuleNotFoundError` naming it: nothing is
skipped silently.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "the panels of maskunet_tpu_torch.utils.visualize need "
            "matplotlib, which this host does not have", name="matplotlib"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _imshow(ax, img, title):
    if img.ndim == 3 and img.dtype != np.uint8 and img.max() <= 1.0:
        img = (img * 255).astype(np.uint8)
    ax.imshow(img)
    ax.set_title(title)
    ax.axis("off")


def save_sample(example: dict, path: str) -> None:
    """Image / label [/ instance] panel for one dataset example."""
    plt = _pyplot()
    keys = [k for k in ("image", "label", "instance") if k in example]
    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]
    for ax, key in zip(axes, keys):
        _imshow(ax, np.asarray(example[key]), key)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def save_prediction(image: np.ndarray, label: np.ndarray,
                    pred: np.ndarray, path: str) -> None:
    """Original / ground-truth / predicted-mask panel
    (visualize_predictions layout, ade_semantic.py:487-501)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    _imshow(axes[0], np.asarray(image), "Original Image")
    _imshow(axes[1], np.asarray(label), "Ground Truth")
    _imshow(axes[2], np.asarray(pred), "Predicted Mask")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
