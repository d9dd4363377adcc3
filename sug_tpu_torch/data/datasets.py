"""PointDA-10 dataset ingest: the port's own copy of what inference and DG
training need from ``sug_tpu/data/datasets.py``.

On-disk contract: ``<data_root>/<dataset>/{train,test}_pts.npy`` and
``_label.npy``. Ingest normalises each cloud (centre + max-norm), applies the
fixed -pi/2 x-rotation to non-modelnet data under DGCNN (or as
``fixed_x_rotation`` says), and pads or subsamples to ``num_points``,
producing one contiguous (M, num_points, 3) float32 array. The train-time
sub-domain split is ``create_splitted_dataset`` (the ``Random`` splitter);
``make_synthetic_pointda`` makes stand-in data for tests and smoke runs.
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from sug_tpu_torch.losses.classification import class_weights

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
    labels, ingested without augmentation (the trainer augments on the
    device). ``fixed_x_rotation`` None applies the reference's fixed -pi/2
    x-rotation to non-modelnet data under DGCNN; True or False forces it."""

    def __init__(
        self,
        dataset_type: str,
        pts: np.ndarray,
        labels: np.ndarray,
        num_points: int = DEFAULT_NUM_POINTS,
        model: str = "Pointnet",
        fixed_x_rotation: Optional[bool] = None,
    ):
        if pts.shape[0] != labels.shape[0]:
            raise ValueError(f"pts/label count mismatch: {pts.shape[0]} vs {labels.shape[0]}")
        self.dataset_type = dataset_type
        self.num_points = num_points
        self.model = model

        pts = normalize_pc_np(np.asarray(pts, dtype=np.float32)[..., :3])
        if fixed_x_rotation is None:
            fixed_x_rotation = dataset_type != "modelnet" and model == "DGCNN"
        if fixed_x_rotation:
            pts = (pts @ _rot_x_np(-np.pi / 2)).astype(np.float32)
        pts = fit_num_points(pts, num_points, np.random.default_rng(SUBSAMPLE_SEED))

        self.pts = np.ascontiguousarray(pts, dtype=np.float32)
        self.labels = np.asarray(labels, dtype=np.int32).reshape(-1)
        # dataset indices of each class, and the class counts
        self.indices = [np.nonzero(self.labels == c)[0].tolist() for c in range(NUM_CLASS)]
        self.cls_num_counter = [len(ix) for ix in self.indices]

    def __len__(self) -> int:
        return self.pts.shape[0]

    def cls_wights(self, weighting: str = "number_inverse", q_=None) -> np.ndarray:
        """Per-class weights for the focal / ClassWeighting losses (the
        reference's name, spelling included); a string ``q_`` selects the
        adaptive DLSA q."""
        return class_weights(self.cls_num_counter, weighting, q=q_, adaptive_q=isinstance(q_, str))


def create_single_dataset(
    dataset_type: str,
    status: str = "test",
    pc_num: int = DEFAULT_NUM_POINTS,
    model: str = "Pointnet",
    data_root: Optional[str] = None,
    fixed_x_rotation: Optional[bool] = None,
) -> PointCloudDataset:
    """A whole split of one dataset."""
    if dataset_type not in DATASET_LIST:
        raise ValueError(f"Not supported dataset {dataset_type}!")
    pts, labels = load_dataset_full(dataset_type, status, data_root)
    if len(set(labels.tolist())) != NUM_CLASS:
        raise ValueError(f"{dataset_type}/{status} has fewer than {NUM_CLASS} classes")
    return PointCloudDataset(dataset_type, pts, labels, num_points=pc_num, model=model,
                             fixed_x_rotation=fixed_x_rotation)


def _index_cache_name(split_config) -> str:
    """The ``.pkl`` index cache's file name, as the JAX package names it."""
    if split_config.get("FILE", None):
        return split_config["FILE"]
    size_usage = split_config["SAMPLE_RATE"] + (1 if split_config["SUBSET_FULLSIZE"] else 0.5)
    stem = f"size_{size_usage}{split_config['METHOD']}_{split_config['SAMPLE_RATE']}"
    tag = split_config.get("EXTRA_TAG", None)
    if tag == "Datetime":
        tag = str(datetime.datetime.now())
    return f"{stem}_{tag}.pkl" if tag else f"{stem}.pkl"


def random_split(dataset_type: str, split_config, status: str = "train",
                 data_root: Optional[str] = None, logger=None) -> Dict[str, Dict[str, np.ndarray]]:
    """The ``Random`` train-time splitter: ``SAMPLE_RATE`` of the clouds
    drawn with numpy's global random state into subset_1, the rest (or, with
    ``SUBSET_FULLSIZE``, all) into subset_2. The index pair is cached in a
    ``.pkl`` beside the dumps and reloaded when ``RELOAD`` is set."""
    if split_config["METHOD"] != "Random":
        raise NotImplementedError(
            f"DATASET_SPLITTER.METHOD {split_config['METHOD']!r} is not ported yet (the "
            "port has the Random splitter); the others are queued in ROADMAP.md"
        )
    root = resolve_data_root(data_root)
    full_pts, full_label = load_dataset_full(dataset_type, status, root)
    cache = os.path.join(root, dataset_type, _index_cache_name(split_config))
    if os.path.exists(cache) and split_config.get("RELOAD", False):
        if logger:
            logger.info(f"Direct load the indexing history from {cache}")
        with open(cache, "rb") as f:  # an index pair this splitter wrote
            indexes = pickle.load(f)
        i1, i2 = indexes["index1"], indexes["index2"]
    else:
        index_array = np.arange(full_pts.shape[0])
        size_1 = int(full_pts.shape[0] * split_config["SAMPLE_RATE"])
        i1 = np.random.choice(index_array, replace=False, size=size_1)
        i2 = index_array if split_config["SUBSET_FULLSIZE"] else np.setdiff1d(index_array, i1)
        with open(cache, "wb") as f:
            pickle.dump({"index2": i2, "index1": i1}, f)
        if logger:
            logger.info(f"Save indexing history to {cache}")
    return {
        "subset_1": {"pts": full_pts[i1], "label": full_label[i1]},
        "subset_2": {"pts": full_pts[i2], "label": full_label[i2]},
    }


def create_splitted_dataset(
    dataset_type: str,
    status: str = "train",
    config=None,
    logger=None,
    pc_num: int = DEFAULT_NUM_POINTS,
    model: str = "Pointnet",
    data_root: Optional[str] = None,
    fixed_x_rotation: Optional[bool] = None,
) -> List[PointCloudDataset]:
    """The two sub-domains of one dataset's split, as datasets."""
    if dataset_type not in DATASET_LIST:
        raise ValueError(f"Not supported dataset {dataset_type}!")
    split = random_split(dataset_type, config, status=status, data_root=data_root, logger=logger)
    return [
        PointCloudDataset(dataset_type, split[name]["pts"], split[name]["label"], num_points=pc_num,
                          model=model, fixed_x_rotation=fixed_x_rotation)
        for name in ("subset_1", "subset_2")
    ]


def make_synthetic_pointda(
    num_per_class: int = 24,
    num_points: int = DEFAULT_NUM_POINTS,
    num_class: int = NUM_CLASS,
    seed: int = 0,
    noise: float = 0.02,
) -> Tuple[np.ndarray, np.ndarray]:
    """10 geometrically distinct classes (ellipsoids, cylinders, cuboid
    shells, cones and tori whose shape ratios depend on the class) for tests
    and smoke runs where PointDA-10 is not at hand: the port's copy of the
    JAX package's generator without its scan degradations."""
    rng = np.random.default_rng(seed)
    clouds, labels = [], []
    for c in range(num_class):
        for _ in range(num_per_class):
            u = rng.uniform(0, 2 * np.pi, num_points)
            v = rng.uniform(-1, 1, num_points)
            t = c / num_class
            if c % 5 == 0:  # ellipsoid, elongation varies
                e = 0.3 + 1.4 * t
                phi = np.arccos(v)
                pc = np.stack([np.sin(phi) * np.cos(u), np.sin(phi) * np.sin(u), e * np.cos(phi)], 1)
            elif c % 5 == 1:  # cylinder, height/radius ratio varies
                pc = np.stack([np.cos(u), np.sin(u), (0.4 + t) * v], axis=1)
            elif c % 5 == 2:  # cuboid shell, aspect varies
                pc = rng.uniform(-1, 1, (num_points, 3))
                axis = rng.integers(0, 3, num_points)
                pc[np.arange(num_points), axis] = rng.choice([-1.0, 1.0], num_points)
                pc[:, 2] *= 0.4 + 1.2 * t
            elif c % 5 == 3:  # cone, apex angle varies
                z = rng.uniform(0, 1, num_points)
                r = (1 - z) * (0.3 + t)
                pc = np.stack([r * np.cos(u), r * np.sin(u), z], axis=1)
            else:  # torus, tube radius varies
                rt = 0.15 + 0.3 * t
                ring = 1 + rt * np.cos(v * np.pi)
                pc = np.stack([ring * np.cos(u), ring * np.sin(u), rt * np.sin(v * np.pi)], axis=1)
            clouds.append((pc + rng.normal(0, noise, pc.shape)).astype(np.float32))
            labels.append(c)
    order = rng.permutation(len(clouds))
    return np.stack(clouds)[order], np.array(labels, dtype=np.int64)[order]
