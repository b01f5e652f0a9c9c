"""Debug plots (counterpart of sd_lora_trainer_tpu/utils/plots.py, a copy).

Loss curves with Savitzky-Golay smoothing, LR schedules, gradient norms,
token-embedding stds and weight histograms, written as PNGs at checkpoints
when `config.debug` is on. matplotlib is imported inside the functions (only
`debug` needs it); each function does nothing where it is missing.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def plot_loss(losses: Dict[str, List[float]], save_path: str) -> None:
    """Loss curves, smoothed when long enough (reference: utils.py:239-280)."""
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 6))
    for name, series in losses.items():
        if not series:
            continue
        xs = np.arange(len(series))
        ys = np.asarray(series, np.float64)
        if len(ys) > 21:
            try:
                from scipy.signal import savgol_filter

                ys_smooth = savgol_filter(ys, 21, 3)
                ax.plot(xs, ys, alpha=0.25)
                ax.plot(xs, ys_smooth, label=name)
                continue
            except Exception:
                pass
        ax.plot(xs, ys, label=name)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def plot_lrs(lr_history: Dict[str, List[float]], save_path: str) -> None:
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 4))
    for name, series in lr_history.items():
        if series:
            ax.plot(series, label=name)
    ax.set_xlabel("step")
    ax.set_ylabel("lr")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def plot_grad_norms(grad_norms: Dict[str, List[float]], save_path: str) -> None:
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 4))
    for name, series in grad_norms.items():
        if series:
            ax.plot(series, label=name)
    ax.set_xlabel("step")
    ax.set_ylabel("grad norm")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def plot_token_stds(
    token_stds: Dict[str, List[float]], save_path: str, target_value_dict: Optional[dict] = None
) -> None:
    """Per-token embedding std trajectories vs the pretrained target
    (reference: utils.py:206-236)."""
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 4))
    for name, series in token_stds.items():
        if series:
            ax.plot(series, label=name)
    for name, value in (target_value_dict or {}).items():
        ax.axhline(value, linestyle="--", alpha=0.5, label=name)
    ax.set_xlabel("step")
    ax.set_ylabel("token embedding std")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def plot_param_histogram(
    values: np.ndarray, save_path: str, min_val: float = -0.4, max_val: float = 0.4
) -> None:
    """Weight histogram (reference plot_torch_hist: utils.py:121-150)."""
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(np.asarray(values).ravel(), bins=100, range=(min_val, max_val))
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
