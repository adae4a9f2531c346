"""Registration/translation quality metrics.

The reference repo ships no quantitative evaluation (its paper reports
registration accuracy on a never-released private dataset — SURVEY.md §7).
These metrics make the evaluation reproducible:

  * photometric: NCC / PSNR / L1 between the registered translation and the
    target modality,
  * geometric: end-point error (EPE, in pixels) between the predicted
    displacement field and a known ground-truth warp — available for the
    synthetic dataset, whose misalignment is generated and therefore known.
"""

from __future__ import annotations

import numpy as np


def l1(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(a) - np.asarray(b))))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """PSNR for [-1, 1] images (data_range 2)."""
    mse = np.mean(np.square(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))

def ncc(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized cross-correlation in [-1, 1], averaged over the batch."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a, b = a[None], b[None]
    n = a.shape[0]
    a = a.reshape(n, -1)
    b = b.reshape(n, -1)
    a = a - a.mean(axis=1, keepdims=True)
    b = b - b.mean(axis=1, keepdims=True)
    denom = np.sqrt((a * a).sum(axis=1) * (b * b).sum(axis=1)) + 1e-12
    return float(((a * b).sum(axis=1) / denom).mean())


def registration_gt_flow(theta_m: np.ndarray, height: int, width: int) -> np.ndarray:
    """Ground-truth NORMALIZED field the STN should predict for synthetic A.

    theta_m is the (2, 3) center-origin map M (output px -> source px) the
    synthetic dataset used to RENDER the misaligned A (A(p) = scene(M(p))).
    Aligning A back to the reference geometry samples A at q(p) = M⁻¹(p),
    so the target displacement is φ(p) = M⁻¹(p) − p, returned in normalized
    grid units (align_corners=False: 2/size per pixel).
    """
    r = theta_m[:, :2]
    t = theta_m[:, 2]
    r_inv = np.linalg.inv(r)
    t_inv = -r_inv @ t

    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    cx, cy = width / 2.0, height / 2.0
    x = xs - cx
    y = ys - cy
    qx = r_inv[0, 0] * x + r_inv[0, 1] * y + t_inv[0]
    qy = r_inv[1, 0] * x + r_inv[1, 1] * y + t_inv[1]
    dx = (qx - x) * 2.0 / width
    dy = (qy - y) * 2.0 / height
    return np.stack([dx, dy], axis=-1).astype(np.float32)


def epe_px(flow_pred: np.ndarray, flow_gt: np.ndarray,
           height: int, width: int) -> float:
    """Mean end-point error in PIXELS between normalized flow fields."""
    fp = np.asarray(flow_pred, np.float64)
    fg = np.asarray(flow_gt, np.float64)
    dx = (fp[..., 0] - fg[..., 0]) * width / 2.0
    dy = (fp[..., 1] - fg[..., 1]) * height / 2.0
    return float(np.mean(np.sqrt(dx * dx + dy * dy)))
