"""PointDA-10 dataset ingest for evaluation: the port's own copy of what
inference needs from ``sug_tpu/data/datasets.py``.

On-disk contract: ``<data_root>/<dataset>/{train,test}_pts.npy`` and
``_label.npy``. Ingest normalises each cloud (centre + max-norm), applies the
fixed -pi/2 x-rotation to non-modelnet data under DGCNN, and pads or
subsamples to ``num_points``, producing one contiguous (M, num_points, 3)
float32 array. Training-time augmentation and the sub-domain splitter come
with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

DATASET_LIST = ["scannet", "shapenet", "modelnet"]
NUM_CLASS = 10
DEFAULT_NUM_POINTS = 1024
SUBSAMPLE_SEED = 666  # the random subsample of clouds longer than num_points


def resolve_data_root(path: Optional[str] = None) -> str:
    """An explicit path, else ``$SUG_DATA_ROOT``, else ``./data/PointDA_data``."""
    if path is not None:
        return path
    return os.environ.get("SUG_DATA_ROOT", os.path.join("data", "PointDA_data"))


def load_dataset_full(
    dataset_type: str, status: str = "train", data_root: Optional[str] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """The unified per-dataset dump: (pts, labels)."""
    root = resolve_data_root(data_root)
    pts = np.load(os.path.join(root, dataset_type, f"{status}_pts.npy"))
    labels = np.load(os.path.join(root, dataset_type, f"{status}_label.npy"))
    return pts, labels


def normalize_pc_np(pc: np.ndarray) -> np.ndarray:
    """Vectorized (M, N, 3) centre + max-norm scale."""
    pc = pc - pc.mean(axis=-2, keepdims=True)
    max_norm = np.sqrt((pc**2).sum(-1)).max(axis=-1)[..., None, None]
    return pc / np.maximum(max_norm, 1e-12)


def _rot_x_np(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def fit_num_points(pts: np.ndarray, num_points: int, rng: np.random.Generator) -> np.ndarray:
    """Zero-pad or randomly subsample each cloud to exactly num_points."""
    M, N, C = pts.shape
    if N == num_points:
        return pts
    if N < num_points:
        pad = np.zeros((M, num_points - N, C), dtype=pts.dtype)
        return np.concatenate([pts, pad], axis=1)
    idx = np.stack([rng.permutation(N)[:num_points] for _ in range(M)])
    return np.take_along_axis(pts, idx[..., None], axis=1)


class PointCloudDataset:
    """In-memory dataset: one (M, num_points, 3) float32 array and its
    labels, ingested without augmentation. Non-modelnet data under DGCNN get
    the reference's fixed -pi/2 x-rotation."""

    def __init__(
        self,
        dataset_type: str,
        pts: np.ndarray,
        labels: np.ndarray,
        num_points: int = DEFAULT_NUM_POINTS,
        model: str = "Pointnet",
    ):
        if pts.shape[0] != labels.shape[0]:
            raise ValueError(f"pts/label count mismatch: {pts.shape[0]} vs {labels.shape[0]}")
        self.dataset_type = dataset_type
        self.num_points = num_points
        self.model = model

        pts = normalize_pc_np(np.asarray(pts, dtype=np.float32)[..., :3])
        if dataset_type != "modelnet" and model == "DGCNN":
            pts = (pts @ _rot_x_np(-np.pi / 2)).astype(np.float32)
        pts = fit_num_points(pts, num_points, np.random.default_rng(SUBSAMPLE_SEED))

        self.pts = np.ascontiguousarray(pts, dtype=np.float32)
        self.labels = np.asarray(labels, dtype=np.int32).reshape(-1)

    def __len__(self) -> int:
        return self.pts.shape[0]


def create_single_dataset(
    dataset_type: str,
    status: str = "test",
    pc_num: int = DEFAULT_NUM_POINTS,
    model: str = "Pointnet",
    data_root: Optional[str] = None,
) -> PointCloudDataset:
    """A whole split of one dataset."""
    if dataset_type not in DATASET_LIST:
        raise ValueError(f"Not supported dataset {dataset_type}!")
    pts, labels = load_dataset_full(dataset_type, status, data_root)
    if len(set(labels.tolist())) != NUM_CLASS:
        raise ValueError(f"{dataset_type}/{status} has fewer than {NUM_CLASS} classes")
    return PointCloudDataset(dataset_type, pts, labels, num_points=pc_num, model=model)
