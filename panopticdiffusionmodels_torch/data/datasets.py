"""Datasets of the training slices: CIFAR-10, CelebA and raw ImageNet images,
MS-COCO pre-encoded features with panoptic maps, ImageNet pre-encoded
features with labels, and synthetic data of the same shapes.

A numpy + PIL copy of `panopticdiffusionmodels_tpu/data/datasets.py`.
Samples are numpy arrays, channel-last like the JAX package's: images
(H, W, 3) f32 in [-1, 1], moments (h, w, 2C) f32, context (77, clip_dim)
f32, panoptic ids (H, W, 1) int32, labels int.  CIFAR-10 is read from its
python-pickle batches; CelebA and ImageNet from image trees, centre-cropped
and bicubic-resized with PIL.  The feature files are those of the reference
extraction scripts (COCO: `{i}.npy` moments (2C, h, w), `{i}_{k}.npy` CLIP
contexts, `{i}_seg.npy` seg maps, reference `datasets.py:564-613`; ImageNet:
`{i}.npy` a pickled (moments (2C, h, w), label) pair, reference
`datasets.py:187-198`), so the same directory trains either package.
"""
from __future__ import annotations

import os
import pickle
import random
from typing import Optional, Sequence, Tuple

import numpy as np


class DatasetFactory:
    """train/test splits (reference `datasets.py:84-130`).  `get_split`
    strips a labeled dataset to its first field unless `labeled=True`, as
    the JAX `get_split` does; training passes `labeled=True`."""

    def __init__(self):
        self.train = None
        self.test = None

    def get_split(self, split: str, labeled: bool = False):
        if split not in ("train", "test"):
            raise ValueError(split)
        dataset = getattr(self, split)
        if self.has_label and not labeled:
            return UnlabeledDataset(dataset)
        return dataset

    def unpreprocess(self, v):
        """[-1, 1] -> [0, 1] image space (reference `datasets.py:118-121`)."""
        return np.clip(0.5 * (v + 1.0), 0.0, 1.0)

    @property
    def has_label(self) -> bool:
        return True


class UnlabeledDataset:
    """Only the first field of each sample (reference `datasets.py:19-28`)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        data = self.dataset[item]
        return data[0] if isinstance(data, tuple) else data


class CFGDataset:
    """Replace the context by the empty one w.p. p_uncond, for classifier-free
    guidance training (reference `datasets.py:45-81`).  Draws from the
    `random` module's global state, as the JAX package does."""

    def __init__(self, dataset, p_uncond: float, empty_token):
        self.dataset = dataset
        self.p_uncond = p_uncond
        self.empty_token = empty_token

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        data = self.dataset[item]
        x, y, rest = data[0], data[1], data[2:]
        if random.random() < self.p_uncond:
            y = self.empty_token
        return (x, y, *rest)


def min_pool_2d(x: np.ndarray, k: int) -> np.ndarray:
    """k x k min-pool of an (H, W) map: the reference downsamples panoptic maps
    256 -> 64 with MinPool2d(4) (reference `datasets.py:591`)."""
    h, w = x.shape
    return x.reshape(h // k, k, w // k, k).min(axis=(1, 3))


class MSCOCOFeatureDataset:
    """Pre-encoded MS-COCO sample: (moments, CLIP context[, panoptic map][, i]).

    Per index i: `{i}.npy` moments (2C, h, w); `{i}_{k}.npy` CLIP context
    (77, 768) for caption k in 0..num_captions-1, one at random unless
    `deterministic`; `{i}_seg.npy` seg map (256, 256) int, min-pooled to
    mask_size.  Without seg files the panoptic field is left out."""

    def __init__(self, path: str, num_captions: int = 5, mask_size: int = 64,
                 deterministic: bool = False, return_index: bool = False):
        self.path = path
        self.num_captions = num_captions
        self.mask_size = mask_size
        self.deterministic = deterministic
        self.return_index = return_index
        names = [n for n in os.listdir(path) if n.endswith("_seg.npy")]
        self.has_seg = bool(names)
        if self.has_seg:
            self.indices = sorted(int(n.split("_")[0]) for n in names)
        else:
            self.indices = sorted(int(n[:-4]) for n in os.listdir(path)
                                  if n.endswith(".npy") and n[:-4].isdigit())

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, item):
        i = self.indices[item]
        z = np.load(os.path.join(self.path, f"{i}.npy"))
        k = 0 if self.deterministic else random.randint(0, self.num_captions - 1)
        context = np.load(os.path.join(self.path, f"{i}_{k}.npy"))
        out = (np.ascontiguousarray(z.transpose(1, 2, 0)).astype(np.float32),
               context.astype(np.float32))
        if self.has_seg:
            seg = np.load(os.path.join(self.path, f"{i}_seg.npy"))
            pool = seg.shape[0] // self.mask_size
            if pool > 1:
                seg = min_pool_2d(seg, pool)
            out = (*out, seg[..., None].astype(np.int32))
        return (*out, i) if self.return_index else out


class MSCOCO256Features(DatasetFactory):
    """mscoco256_features (reference `datasets.py:616-652`): `train/` and `val/`
    feature dirs and `empty_context.npy` for CFG."""

    def __init__(self, path: str, cfg: bool = False, p_uncond: Optional[float] = None,
                 mask_size: int = 64):
        super().__init__()
        self.path = path
        train = MSCOCOFeatureDataset(os.path.join(path, "train"), mask_size=mask_size)
        self.test = MSCOCOFeatureDataset(os.path.join(path, "val"), mask_size=mask_size,
                                         deterministic=True, return_index=True)
        self.empty_context = np.load(os.path.join(path, "empty_context.npy"))
        if cfg:
            if p_uncond is None:
                raise ValueError("mscoco256_features: cfg=True needs p_uncond")
            self.train = CFGDataset(train, p_uncond, self.empty_context)
        else:
            self.train = train


class FeatureDataset:
    """ImageNet latent-moment features: each `{i}.npy` pickles a (moments CHW,
    label) pair, flip-augmented to 2x the raw image count by the extraction
    (reference `datasets.py:187-198`).  Returns (moments HWC f32, int label)."""

    def __init__(self, path: str, n: Optional[int] = None):
        self.path = path
        if n is None:
            n = len([name for name in os.listdir(path) if name.endswith(".npy")])
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        z, label = np.load(os.path.join(self.path, f"{idx}.npy"), allow_pickle=True)
        z = np.asarray(z, dtype=np.float32)
        return np.ascontiguousarray(z.transpose(1, 2, 0)), int(label)


class CFGLabelDataset:
    """Label-null CFG dropout for class-conditional models (reference
    `datasets.py:45-58`): the label becomes `null_label` where a uniform draw
    is < p_uncond, the JAX package's rule.  The JAX package draws from the
    global `random` module; here the draw of `item` in epoch e comes from
    `random.Random` seeded by (seed, e, item), which `Loader` sets through
    `set_epoch`, so it is reproducible from the loader's seed whatever order
    the loader's threads read the items in, and a resumed run draws what the
    uninterrupted one drew."""

    def __init__(self, dataset, p_uncond: float, null_label: int):
        self.dataset = dataset
        self.p_uncond = p_uncond
        self.null_label = null_label
        self.seed, self.epoch = 0, 0

    def set_epoch(self, epoch: int, seed: int) -> None:
        self.seed, self.epoch = seed, epoch

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        x, y = self.dataset[item]
        if random.Random(f"{self.seed}:{self.epoch}:{item}").random() < self.p_uncond:
            y = self.null_label
        return x, y


class ImageNetFeatures(DatasetFactory):
    """imagenet256_features / imagenet512_features (reference
    `datasets.py:187-250`): label K = 1000 is the null class of
    class-conditional CFG (reference `eval.py:43-46`, num_classes 1001)."""

    def __init__(self, path: str, cfg: bool = False, p_uncond: Optional[float] = None,
                 resolution: int = 256):
        super().__init__()
        self.resolution = resolution
        train = FeatureDataset(path)
        self.K = 1000
        if cfg:
            if p_uncond is None:
                raise ValueError("imagenet features: cfg=True needs p_uncond")
            self.train = CFGLabelDataset(train, p_uncond, self.K)
        else:
            self.train = train
        self.test = train


# --- pixel-space images ----------------------------------------------------


def _load_cifar10_arrays(path: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 NHWC images and int32 labels from the python-pickle batches."""
    batch_dir = os.path.join(path, "cifar-10-batches-py")
    root = batch_dir if os.path.isdir(batch_dir) else path
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(batch[b"data"], dtype=np.uint8))
        ys.append(np.asarray(batch[b"labels"], dtype=np.int32))
    return np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), np.concatenate(ys)


class ArrayImageDataset:
    """In-memory uint8 NHWC images as f32 in [-1, 1], optionally flipped
    left-right with probability 1/2 (the `random` module's global state, as
    the JAX package draws it)."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray] = None,
                 random_flip: bool = False):
        self.images = images
        self.labels = labels
        self.random_flip = random_flip

    def __len__(self):
        return len(self.images)

    def __getitem__(self, item):
        img = self.images[item].astype(np.float32) / 127.5 - 1.0
        if self.random_flip and random.random() < 0.5:
            img = img[:, ::-1, :].copy()
        if self.labels is None:
            return img
        return img, int(self.labels[item])


class CIFAR10(DatasetFactory):
    """CIFAR-10 from `cifar-10-batches-py` (reference `datasets.py:135-181`):
    50,000 training images; with `cfg`, labels dropped to the null class 10
    at `p_uncond`."""

    def __init__(self, path: str, random_flip: bool = False, cfg: bool = False,
                 p_uncond: Optional[float] = None):
        super().__init__()
        x_train, y_train = _load_cifar10_arrays(path, train=True)
        x_test, y_test = _load_cifar10_arrays(path, train=False)
        train = ArrayImageDataset(x_train, y_train, random_flip=random_flip)
        if cfg:
            if p_uncond is None:
                raise ValueError("cifar10: cfg=True needs p_uncond")
            train = CFGLabelDataset(train, p_uncond, 10)
        self.train = train
        self.test = ArrayImageDataset(x_test, y_test)
        assert len(self.train) == 50000, len(self.train)


class FolderImageDataset:
    """Image files centre-cropped to a square and bicubic-resized to
    `resolution` with PIL, as f32 in [-1, 1] (reference `ImageDataset`,
    `datasets.py:304-384`, its used paths), optionally flipped as
    `ArrayImageDataset` flips."""

    def __init__(self, paths: Sequence[str], resolution: int, labels=None,
                 random_flip: bool = True):
        self.paths = list(paths)
        self.resolution = resolution
        self.labels = labels
        self.random_flip = random_flip

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, item):
        from PIL import Image

        img = Image.open(self.paths[item]).convert("RGB")
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
        img = img.resize((self.resolution, self.resolution), Image.BICUBIC)
        arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
        if self.random_flip and random.random() < 0.5:
            arr = arr[:, ::-1, :].copy()
        if self.labels is None:
            return arr
        return arr, int(self.labels[item])


class CelebA(DatasetFactory):
    """CelebA at 64x64 from `img_align_celeba/` (reference
    `datasets.py:406-441`): every image trains, flipped; the first 512 test."""

    def __init__(self, path: str, resolution: int = 64):
        super().__init__()
        img_dir = os.path.join(path, "img_align_celeba")
        root = img_dir if os.path.isdir(img_dir) else path
        paths = sorted(os.path.join(root, p) for p in os.listdir(root)
                       if p.lower().endswith((".jpg", ".png", ".jpeg")))
        self.resolution = resolution
        self.train = FolderImageDataset(paths, resolution, random_flip=True)
        self.test = FolderImageDataset(paths[:512], resolution, random_flip=False)

    @property
    def has_label(self):
        return False


class ImageNetRaw(DatasetFactory):
    """Class-labelled ImageNet from a `train/<class>/*.JPEG` tree (reference
    `datasets.py:253-301`), classes in sorted order, centre-cropped to
    `resolution`; with `cfg`, labels dropped to the null class (the number
    of classes) at `p_uncond`."""

    def __init__(self, path: str, resolution: int = 64, random_flip: bool = True,
                 cfg: bool = False, p_uncond: Optional[float] = None):
        super().__init__()
        self.resolution = resolution
        train_root = os.path.join(path, "train")
        root = train_root if os.path.isdir(train_root) else path
        classes = sorted(c for c in os.listdir(root) if os.path.isdir(os.path.join(root, c)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        paths, labels = [], []
        for cname in classes:
            cdir = os.path.join(root, cname)
            for n in sorted(os.listdir(cdir)):
                if n.lower().endswith((".jpeg", ".jpg", ".png")):
                    paths.append(os.path.join(cdir, n))
                    labels.append(self.class_to_idx[cname])
        train = FolderImageDataset(paths, resolution, labels=labels, random_flip=random_flip)
        if cfg:
            if p_uncond is None:
                raise ValueError("imagenet: cfg=True needs p_uncond")
            train = CFGLabelDataset(train, p_uncond, len(classes))
        self.train = train
        self.test = FolderImageDataset(paths[:512], resolution, labels=labels[:512],
                                       random_flip=False)


class SyntheticDataset:
    """Seeded numpy fields: normal f32, or ids in [0, 200] for `int_fields`."""

    def __init__(self, shapes, n: int = 256, seed: int = 0, int_fields=()):
        rng = np.random.default_rng(seed)
        self.fields = []
        for i, shape in enumerate(shapes):
            if i in int_fields:
                self.fields.append(rng.integers(0, 201, size=(n, *shape)).astype(np.int32))
            else:
                self.fields.append(rng.normal(size=(n, *shape)).astype(np.float32))
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, item):
        vals = tuple(f[item] for f in self.fields)
        return vals if len(vals) > 1 else vals[0]


class SyntheticLabeled:
    """Seeded (array, int label) pairs for class-conditional tasks: the same
    arrays as the JAX package's for the same seed."""

    def __init__(self, shape, n: int, num_classes: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, *shape)).astype(np.float32)
        self.y = rng.integers(0, num_classes, n).astype(np.int32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, item):
        return self.x[item], int(self.y[item])


class Synthetic(DatasetFactory):
    """Synthetic data of a task's shapes, the same arrays as the JAX package's
    `Synthetic` for the same seed: `style` 'coco' (moments, context[,
    panoptic]), 'imagenet' (moments, label) or 'pixels' (image, label), labels
    in [0, num_classes)."""

    def __init__(self, n: int = 256, z_shape=(32, 32, 8), clip_shape=(77, 768),
                 mask_size: int = 64, panoptic: bool = True, seed: int = 0,
                 style: str = "coco", num_classes: int = 10):
        super().__init__()
        if style == "coco":
            shapes, int_fields = [z_shape, clip_shape], ()
            if panoptic:
                shapes.append((mask_size, mask_size, 1))
                int_fields = (2,)
            self.train = SyntheticDataset(shapes, n=n, seed=seed, int_fields=int_fields)
            self.empty_context = np.zeros(clip_shape, dtype=np.float32)
        elif style in ("imagenet", "pixels"):
            self.train = SyntheticLabeled(z_shape, n, num_classes, seed=seed)
        else:
            raise ValueError(style)
        self.test = self.train


def get_dataset(name: str, **kwargs) -> DatasetFactory:
    """Factory over a config's `dataset` fields (reference `datasets.py:655-669`)."""
    if name == "mscoco256_features":
        return MSCOCO256Features(**kwargs)
    if name in ("imagenet256_features", "imagenet512_features"):
        return ImageNetFeatures(resolution=256 if "256" in name else 512, **kwargs)
    if name == "synthetic":
        return Synthetic(**kwargs)
    if name == "cifar10":
        return CIFAR10(**kwargs)
    if name == "celeba":
        return CelebA(**kwargs)
    if name == "imagenet":
        return ImageNetRaw(**kwargs)
    raise NotImplementedError(name)
